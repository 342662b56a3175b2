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
* ``power_step`` — every step: on CUDA tensors one call that makes two
  launches (one without normalization), counted in
  ``power_step.launches``, or raises; on CPU tensors
  ``power_step_plain``, the port's eager code as it stood, op for op, so
  the kernel is held bitwise to it on the card.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.build import BUILD_DIR, is_stale, run_build, tmp_output
from .pattern import PatternGroup, quantize_scales_plain
from .spmv import nvcc

# The kernel's scratch, int32: four vector maxima, two residuals, four
# int8 amax slots and an arrival count (csrc kScratch), 0 between steps.
STEP_SCRATCH = 11
SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "power_step.cu"
LIB_PATH = BUILD_DIR / "libmr_power_step.so"
_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()

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
    # quantizes (each partition's w_len for rv, w_cov for sv).
    scale_group: Optional[PatternGroup] = None


def step_scratch(device) -> torch.Tensor:
    """A window's scratch of the step kernel, zeroed."""
    return torch.zeros(STEP_SCRATCH, dtype=torch.int32, device=device)


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
    rv' = d*(p_rs @ sv) + (1-d) * pref; both max-normalized."""
    y_sr, y_ss, y_rs = products
    sv_new = d * (y_sr + alpha * y_ss)
    rv_new = d * y_rs + (1.0 - d) * pref
    if normalize:
        sv_new = sv_new / sv_new.max()
        rv_new = rv_new / rv_new.max()
    return sv_new, rv_new


def _part_delta(new, old):
    return torch.maximum(
        (new[0] - old[0]).abs().max(), (new[1] - old[1]).abs().max()
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
    step's int8 scales or None) and writes ``residuals[:, i]``; with
    ``plan.tol``, updates ``n_iters`` (int32 0-d) and ``running`` (bool
    0-d) in place."""
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
    deltas = torch.stack([_part_delta(pn, po) for pn, po in zip(new, carry)])
    if plan.tol is None:
        residuals[:, i] = deltas
    else:
        new = tuple(
            tuple(torch.where(running, a, b) for a, b in zip(pn, po))
            for pn, po in zip(new, carry)
        )
        residuals[:, i] = torch.where(running, deltas, 0.0)
        n_iters += running.to(torch.int32)
        running &= deltas.max() > scalar(plan.tol)
    scales = None
    if want_scales:
        scales = quantize_scales_plain(
            plan.scale_group, [p[1] for p in new], [p[0] for p in new]
        )
    return new, scales


def _check(plan, products, carry, residuals, i, n_iters, running, want_scales, dev) -> None:
    if dev.type != "cuda":
        raise ValueError(f"power_step: unsupported device {dev}")
    if len(products) != 2 or len(carry) != 2:
        raise ValueError("power_step: products and carry of two partitions")
    for ys, (sv, rv), pref in zip(products, carry, plan.prefs):
        vecs = (*ys, sv, rv, pref)
        if any(t.device != dev or t.dtype != torch.float32 or not t.is_contiguous()
               for t in vecs):
            raise ValueError(f"power_step: every vector must be contiguous float32 on {dev}")
        v, t = sv.shape[0], rv.shape[0]
        if (ys[0].shape, ys[1].shape, ys[2].shape, pref.shape) != ((v,), (v,), (t,), (t,)) or not (
            v and t
        ):
            raise ValueError("power_step: products, pref and carry of mismatched lengths")
    if residuals.dtype != torch.float32 or residuals.dim() != 2 or residuals.shape[0] != 2 or (
        not residuals.is_contiguous() or residuals.device != dev or not 0 <= i < residuals.shape[1]
    ):
        raise ValueError("power_step: residuals must be contiguous float32 [2, n_steps] on the card")
    if (plan.tol is None) != (n_iters is None) or (n_iters is None) != (running is None):
        raise ValueError("power_step: n_iters and running go with a tol, and only then")
    if plan.scratch.device != dev or plan.scratch.shape != (STEP_SCRATCH,):
        raise ValueError(f"power_step: the plan's scratch must be int32[{STEP_SCRATCH}] on {dev}")
    if want_scales and plan.scale_group is None:
        raise ValueError("power_step: int8 scales need the plan's scale_group")


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
    launch the step kernel (two launches, one without normalization)
    or raise — there is no fallback for a CUDA tensor. The new carry is
    one fresh allocation; the plan's scratch is used by one stream at a
    time."""
    dev = carry[0][0].device
    if dev.type == "cpu":
        return power_step_plain(plan, products, carry, residuals, i, n_iters, running,
                                want_scales)
    _check(plan, products, carry, residuals, i, n_iters, running, want_scales, dev)
    sizes = []
    for sv, rv in carry:
        sizes += [rv.shape[0], sv.shape[0]]
    outs = torch.empty(sum(sizes), dtype=torch.float32, device=dev).split_with_sizes(sizes)
    scales = torch.empty(4, dtype=torch.float32, device=dev) if want_scales else None
    ptrs, ns = [], []
    for p, (ys, (sv, rv), pref) in enumerate(zip(products, carry, plan.prefs)):
        y_sr, y_ss, y_rs = ys
        w_len = w_cov = None
        if want_scales:
            part = plan.scale_group.parts[p]
            if part.w_len.shape != rv.shape or part.w_cov.shape != sv.shape:
                raise ValueError("power_step: the scale group's weights must match the carry")
            w_len, w_cov = part.w_len.data_ptr(), part.w_cov.data_ptr()
        ptrs += [y_rs.data_ptr(), pref.data_ptr(), rv.data_ptr(), outs[2 * p].data_ptr(), w_len,
                 y_sr.data_ptr(), y_ss.data_ptr(), sv.data_ptr(), outs[2 * p + 1].data_ptr(), w_cov]
        ns += [rv.shape[0], sv.shape[0]]
    lib = load_library()
    rc = lib.mr_power_step(
        (ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_int64 * len(ns))(*ns),
        plan.alpha, plan.d, 0.0 if plan.tol is None else plan.tol, int(plan.normalize), i,
        residuals.shape[1],
        plan.scratch.data_ptr(), residuals.data_ptr(),
        None if n_iters is None else n_iters.data_ptr(),
        None if running is None else running.data_ptr(),
        None if scales is None else scales.data_ptr(),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"power_step launch failed: {lib.mr_power_step_error_string(rc).decode()}"
        )
    power_step.launches += 2 if plan.normalize else 1
    return ((outs[1], outs[0]), (outs[3], outs[2])), scales


# Launches of the step kernel (a plain int; power_step is the one place
# that launches it: two a step, one without normalization).
power_step.launches = 0


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
    lib.mr_power_step.restype = ctypes.c_int
    lib.mr_power_step.argtypes = [
        ctypes.POINTER(ptr), ctypes.POINTER(ctypes.c_int64),  # vec_ptrs, ns
        ctypes.c_float, ctypes.c_float, ctypes.c_float,       # alpha, d, tol
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,       # normalize, step, n_steps
        ptr, ptr, ptr, ptr, ptr,                              # scratch, residuals, n_iters, running, scales
        ctypes.c_int, ptr,                                    # device, stream
    ]
    lib.mr_power_step_error_string.restype = ctypes.c_char_p
    lib.mr_power_step_error_string.argtypes = [ctypes.c_int]
    return lib


__all__ = [
    "STEP_SCRATCH",
    "StepPlan",
    "f32_value",
    "power_step",
    "power_step_plain",
    "step_plan",
    "step_scratch",
]
