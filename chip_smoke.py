#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # full size: 1M spans, 5k operations,
                                     # a 6-window replay of 1M-span windows,
                                     # giant windows of 2M and 10M spans
    python3 chip_smoke.py --spans N --giant-spans M  # smaller, same shape of run
    python3 chip_smoke.py --giant-spans 0            # no giant phase
    python3 chip_smoke.py --replay-windows 0         # no replay phase

It drives only the port (``microrank_tpu_torch``) and imports nothing of
JAX or of the JAX package. Phases, one JSON line each:

1. env      — the card, its power limit, the kernels built from the
              sources in this checkout (nvcc for ``csrc/coo_spmv.cu``,
              ``csrc/pattern_pair.cu`` and ``csrc/power_step.cu``, g++ for
              the native span loader / graph builder, all at once), and
              one tiny launch of K1 (a
              row of several chunks, empty rows, padding), of the pcsr
              step (that work list with ELL slabs of widths 4 and 1024,
              then 1 and 64: rows past 256 entries, empty rows) and of
              the pattern pair (f32, bf16 and int8 with its scale launch,
              and K8's kernel in f32; several tiles with ragged edges)
              and chains of three steps of the step kernel (K5: default,
              no normalization, a tol that freezes, an empty partition,
              the int8 scales, and windows at and past the register
              slots; the fused kernel through one window and through
              one-step calls, and the two-launch kernel) held bitwise
              against their plain versions; the fused step kernel's
              occupancy (blocks an SM, register slots) and its ptxas
              lines; and the two
              device timers (torch.profiler, CUDA events) on a 1 GiB
              device copy;
2. data     — one detection window at bench.py's config-5 scale
              (1,000,000 spans, 5,000 operations, 100 trace kinds,
              child_keep_prob 0.55, 60 s fault, seed 0) from the port's
              own generator;
3. run      — ``run_rca_native(..., device="cuda")`` with the pinned
              ``kernel="pallas"``, collapse_kinds "auto" and "off": top-1
              is the injected fault, K1 launches once per power-iteration
              step (25 per ranked window) and computes 2 partitions x 3
              SpMVs in each launch (150 per ranked window), the step
              kernel once per step (25 per ranked window, on every
              route below too), and the CUDA
              run agrees tie-aware (rtol 1e-5) with the same run on the
              CPU; on every route the window, staged once, is run again
              with the plain step (``power_step_plain``) on the card and
              with the two-launch step kernel: weights, vectors,
              residual trace, n_iters and ranking bitwise; the rank
              program timed whole by CUDA events behind a device spin
              (``rank_program_event_ms``) beside the host's time to issue
              it (``rank_program_host_ms``);
4. run      — the same with the default ``kernel="auto"``: collapse
              "auto" resolves to ``kind`` (K2), "off" to ``packed_bf16``
              (K4). Per ranked window 25 pattern-pair launches and 25 K1
              launches of 2 SpMVs (the call-graph terms); tie-aware
              agreement with the CPU run at rtol 1e-5 (kind, f32) or
              5e-3 (packed_bf16), the same top-1 and n_iters; then, collapse
              "off", at two lowered dense budgets (64 MiB and 16 MiB at
              config 5; the two inequalities printed from the window's
              shapes): auto resolves to ``packed_blocked`` (25 launches of
              K8's own kernel and its 25 fold launches, and 25 K1 launches
              of 2 SpMVs per ranked window) and to
              ``pcsr`` (25 launches of the pcsr kernel, 6 SpMVs each, no
              K1 launch), CUDA vs CPU at rtol 1e-5, and pcsr's ranking
              bitwise the pinned pallas run's;
   int8     — the same window with ``kind_precision="int8"``, auto,
              collapse "on" (resolves to ``kind``): per ranked window one
              scale launch (``quantize_amax``, the first step's scales;
              the step kernel gives every later step's), 25 int8 pair
              launches and 25 K1 launches of 2 SpMVs; top-1 the fault; the top-5
              tie-aware against the CPU run at rtol 5e-2 (JAX's own int8
              gate), the same n_iters;
   policy   — a ``policy.json`` in the JAX package's schema for the
              window's workload profile (``method="ochiai"``) through
              ``MICRORANK_POLICY_DIR``: ``run_rca_native`` bitwise an
              explicit ochiai run, one "applied" policy event (every other
              phase runs with an empty policy directory);
5. replay   — ``TableRCA.run`` on the card over bench.py's config-5
              replay (``_run_replay``; its 8 windows cut to 6 so that the
              whole script keeps its time with the follow phase): 6
              consecutive windows of
              1,000,000 spans, every one faulted, from the port's
              ``generate_timeline_with_spans`` (same generator settings as
              phase 2), detect = the generator's window, skip 0; in five
              modes of the loop: sync (depth 1), the default (async stage
              and fetch workers, stream joins, depth 2), async bulk,
              ``chunked`` (bench.py's own: bulk joins,
              ``dispatch_batch_windows=4``, so groups of 4 and 2, each
              one stacked program), ``batch``
              (``run(batch_windows=True)``: one stacked program for all
              windows after the loop) and ``chunked_int8`` (``chunked``
              with ``kind_precision="int8"``: one scale launch a group,
              held to a per-window int8 run, tie-aware top-5 at 5e-2,
              bitwise reported).
              Each mode: one warm pass with a sink (every window ranked
              with ``kind`` and the fault at top-1, the cursor cleared,
              one journal ``window`` event per window, the stage worker's
              stream not the default stream), three timed passes (median
              reported; 25 pattern-pair and 25 K1 launches of 50 SpMVs per
              ranked window in each) and one pass under torch.profiler for
              the device busy share (the union of kernel intervals over
              that pass's wall time); peak device memory, the
              per-window ``rank_dispatch`` / ``rank_wait`` medians and
              the sum of the per-window stages (the rest of a pass is
              per-run work, such as the table's admission, timed apart).
              The
              async and bulk rankings, ``rank_iterations`` and sink
              records are bitwise the sync run's; the chunked and batch
              runs' the same windows, iterations and top-1, rankings
              tie-aware at rtol 1e-5 (bitwise reported), and their
              launches 25 of each kernel per group; a run resumed from
              a cursor saved after window 2 is bitwise windows 3-6. The
              default mode's warm pass records into a fresh metrics
              registry and writes ``metrics.json`` as ``cli run`` does:
              ranked windows, convergence samples and admitted rows as
              counted, ``telemetry`` in the journal's ``run_end``.
              ``--replay-windows`` sets the window count; 0 skips it;
   follow   — ``run_follow`` on the card over the same timeline written
              in three appends (the injected ``sleep`` appends the next
              part), ``idle_exit=1``: its rankings bitwise a sync
              ``TableRCA.run`` over the whole file; polls, windows and
              ms per poll;
   batched  — K18, the stacked rank program: the replay's config-5
              ``kind`` windows (each built by ``prepare_rank``) stacked in
              groups of B = 1, 2, 4 and 6 (``stack_window_graphs``), the
              same windows with ``kind_precision="int8"`` at B = 2 and 6,
              and the config-5 window stacked twice for ``pallas``,
              ``packed_bf16``, ``packed_blocked`` (the 64 MiB run's
              window) and ``pcsr`` (the 16 MiB run's). Each group: 25
              launches of each kernel of its route for the whole group
              (K1, the pair or K8 and its fold, the pcsr step, K5; int8
              one ``quantize_amax`` launch); each window's n_valid and
              n_iters those of its own program, its ranking tie-aware at
              rtol 1e-5 (int8: the top-5 at 5e-2; bitwise reported); the
              group through the plain step on the card bitwise; its
              window-axis kernels bitwise their plain versions (computed
              on the CPU; for packed_bf16 and packed_blocked the windows'
              own launches) and over 50 launches.
              The kind groups and the int8 group of 6 timed in turns with the windows' own
              programs (windows, stacked, stacked, windows; each window's
              program timed alone and the B summed): host issue and
              device time by CUDA events behind a ~100 ms spin, the
              device drained after each call, per program and per
              window;
6. kernel   — K1 at the shapes of phases 3 and 4. Per matrix (groups of
              one, at the uncollapsed shapes), per step of the pallas
              path (the grouped launch of all six matrices, at the
              uncollapsed and the collapsed shapes) and per step of the
              auto path (the launch of both call-graph terms, for kind
              and packed_bf16): bitwise equal to its plain version computed on the
              CPU, bitwise repeatable over 50 launches with every arrival
              counter back at 0, and timed (CUDA events per call behind
              a device spin) beside the plain version, torch.sparse_csr_tensor matvecs (a
              yardstick the port never calls), the byte bound at
              3.35 TB/s, and the first, warp-per-row design of the kernel
              (``mr_coo_spmv_rows``), timed in turns with the chunked one
              (first, chunked, chunked, first); and the pcsr kernel's
              step at the shapes of its run (``measure_pcsr``: bitwise its
              plain version on the CPU, K1 over the earlier pcsr work
              list and the pallas work list of the same window, bitwise
              over 50 launches, rtol 1e-6 on the card; timed in turns
              with that earlier design and six cuSPARSE CSR matvecs by
              CUDA events per call behind a device spin (the kernel's
              own time), over back-to-back calls and by torch.profiler;
              and its two halves as launches of their own);
7. pattern  — K2 (f32 and bf16, at the collapsed shapes of phase 4;
              int8 at the int8 run's: the scale launch, then the pair,
              timed together and apart, its library yardstick
              ``torch._int_mm``) and K4 (packed and packed_bf16,
              uncollapsed): one step for both partitions, bitwise equal
              to its plain
              version computed on the CPU and within rtol 1e-6 of it run
              on the card, bitwise repeatable over 50 launches, equal
              rows and equal columns of a constructed pattern giving
              equal bits, and timed (CUDA events per call behind a
              device spin) beside the plain version, the pair of
              torch.matmul calls over the loop-invariant cast matrix
              (what JAX computes; a yardstick the port never calls) and
              the byte bound; K8's kernel the same at the packed_blocked
              run's window, also held bitwise to the tile kernel in f32 on
              the same inputs and timed in turns with it, its fwd
              partials bitwise their plain layout; plus a sweep of K4 over
              one-partition bitmaps of four shapes;
   step     — K5 at the config-5 ``kind`` window's shapes and the int8
              window's (``measure_step``): one step of the fused kernel
              bitwise its plain version on the card and the
              two-launch kernel, chains of 25 steps through one window
              (25 launches) bitwise with the default configuration, a
              tol, an empty partition, no normalization and (int8) the
              fused scales, both kernels; timed by CUDA events behind a
              spin in turns with the two-launch kernel (old, new, new, old)
              beside the plain step, the byte bound and the host's issue
              time of a window's step call; the grid, blocks an SM and
              register slots; the kind window with a tol that stops it
              early, and a giant-tier window of 262,144 spans with its
              normal partition empty (NaN, and a tol run that stops
              after one step), bitwise the plain step; and the kind rank
              program's host issue split (``rank_issue_split``: the
              set-up before the loop, the 25 steps by wrapper, the
              epilogue), behind a spin;
8. giant    — bench.py's giant-window tier (2048 operations, 4 spans a
              trace) from the port's ``testing.giant_window``, at the
              default 2 GiB budget: 2,097,152 spans (auto must resolve to
              packed_blocked) and 10,485,760 (pcsr), each through
              prepare_rank -> launch_rank -> finalize_rank with its
              partition given and its launches counted; top-5 tie-aware
              against the float64 sparse oracle (rtol 1e-3, as bench.py);
              stage times, rank-program device time and the main path's
              peak device memory; one step of the kernel within rtol 1e-6
              of its plain version on the card, bitwise over 50 launches,
              timed beside the library yardstick and the byte bound (for
              packed_blocked, K8's kernel bitwise the tile kernel in f32
              and timed in turns with it, the design's floor beside the
              bound, and a density sweep at the same shapes: synthetic
              bitmaps of 2%, 50% and 100% from a seeded generator, the
              two kernels bitwise each other and timed; for
              pcsr, ``measure_pcsr`` as in phase 6, against the pallas
              work list of the 10M-span window too); the window through
              the plain step and the two-launch step kernel, bitwise, K5
              measured at its shapes (the kernels line's ``power_step``
              at 10M), and the rank program's issue split; then the
              window stacked twice as one program (``giant_stacked``:
              the host's stacking time and bytes, the staging, 25
              launches of each kernel for the group, each window against
              its own program and through the plain step, the window-axis
              kernels bitwise the window's own launches over 50 launches,
              timed in turns with the two windows' own programs, peak
              device memory). ``--giant-spans``
              sets the larger window (the smaller holds a fifth, the
              budget scales with it); 0 skips the phase.

Then the kernel table, the card's name and power limit, and as the last
line ``{"ok": true, "device": {...}}``. Any failed phase exits non-zero.
Without a CUDA device, or without the port beside this script, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and
# float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# Tolerances: K1 vs its plain version (the same arithmetic; an order
# difference is the only admissible deviation), and the CUDA run vs the
# CPU run (other reductions around K1 sum in another order).
KERNEL_RTOL = 1e-6
RUN_RTOL = 1e-5
RUN_RTOL_BF16 = 5e-3  # bf16 operands (packed_bf16, kind_precision="bf16")
RUN_RTOL_INT8 = 5e-2  # int8 operands: JAX's own int8 gate, over the top-5
STEPS = 25  # power-iteration steps per ranked window: one K1 launch each
STEP_LAUNCHES = 1  # the step kernel's launches per step (K5: one cooperative launch)
SPMVS_PER_STEP = 2 * 3  # partitions x SpMVs per step (pallas)
SS_SPMVS_PER_STEP = 2  # the call-graph terms of both partitions (kind, packed)
REPEATS = 50  # back-to-back launches that must give the first one's bits
SPIN_CYCLES = 4_000_000  # device-side spin before an event-timed call (~2 ms)
PROGRAM_SPIN_CYCLES = 200_000_000  # ~100 ms: longer than a rank program's issue
# bench.py's giant-window tier (BENCH_GIANT_SPANS, BENCH_GIANT_OPS
# defaults): at the default 2 GiB budget, the window of GIANT_SPANS / 5
# spans keeps its bitmaps (about 135 MB) but not its unpacked matrices
# (about 4.3 GB), so auto picks packed_blocked; the window of GIANT_SPANS
# spans has about 672 MB of bitmaps, past a quarter of the budget, so it
# picks pcsr.
GIANT_SPANS = 10_485_760
GIANT_OPS = 2048
DEFAULT_BUDGET = 2 << 30
ORACLE_RTOL = 1e-3  # bench.py's tie-aware top-5 parity against the float64 oracle
# What kernel="auto" resolves to at the config-5 window, per collapse mode.
AUTO_KERNEL = {"auto": "kind", "on": "kind", "off": "packed_bf16"}
# The window loop's modes in the replay phase: synchronous, the default
# (async dispatch, stream joins, depth 2) and async with bulk joins.
REPLAY_MODES = {
    "sync": dict(pipeline_depth=1, async_dispatch=False),
    "default": {},
    "bulk": dict(fetch_mode="bulk"),
    # bench.py's own replay configuration (_run_replay): bulk joins of
    # groups of four windows, each one stacked rank program.
    "chunked": dict(fetch_mode="bulk", dispatch_batch_windows=4),
    # run(batch_windows=True): every window detected, then all of them
    # built and ranked by one stacked program.
    "batch": {},
    # bench.py's chunked setting with kind_precision="int8": groups of
    # four int8 windows, each one stacked program (held to a per-window
    # int8 run).
    "chunked_int8": dict(fetch_mode="bulk", dispatch_batch_windows=4),
}
# The replay modes' kind_precision (f32 where not named).
REPLAY_PRECISION = {"chunked_int8": "int8"}
# The replay modes that rank stacked groups (K18).
STACKED_MODES = ("chunked", "batch", "chunked_int8")
# The stacked rank program's phase: groups of the replay's config-5 kind
# windows.
BATCH_SIZES = (1, 2, 4, 6)


# Seconds from the start of the run to each emitted line, by phase.
PHASE_SECONDS: dict = {}
_T0 = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        key = obj["phase"] if obj["phase"] not in PHASE_SECONDS else f"{obj['phase']}+"
        PHASE_SECONDS[key] = round(time.perf_counter() - _T0, 3)
    print(json.dumps(obj), flush=True)


class PhaseError(RuntimeError):
    pass


def check(cond, msg) -> None:
    if not cond:
        raise PhaseError(msg)


def reset_counts(spmv, pattern) -> None:
    """Every wrapper's launch count to 0, just before a main path runs."""
    from microrank_tpu_torch.ops import step

    spmv.coo_spmv.launches = spmv.coo_spmv.spmvs = 0
    spmv.pcsr_spmv_group.launches = spmv.pcsr_spmv_group.spmvs = 0
    pattern.pattern_pair_group.launches = pattern.pattern_pair_group.products = 0
    pattern.pattern_pair_group.blocked_launches = pattern.pattern_pair_group.fold_launches = 0
    pattern.quantize_scales.launches = 0
    step.power_step.launches = 0
    step.power_step_two_launch.launches = 0


def read_counts(spmv, pattern) -> dict:
    from microrank_tpu_torch.ops import step

    return {
        "step_launches": step.power_step.launches,
        "step_two_launch_launches": step.power_step_two_launch.launches,
        "k1_launches": spmv.coo_spmv.launches,
        "k1_spmvs": spmv.coo_spmv.spmvs,
        "pcsr_launches": spmv.pcsr_spmv_group.launches,
        "pcsr_spmvs": spmv.pcsr_spmv_group.spmvs,
        "pattern_launches": pattern.pattern_pair_group.launches,
        "pattern_products": pattern.pattern_pair_group.products,
        "blocked_launches": pattern.pattern_pair_group.blocked_launches,
        "fold_launches": pattern.pattern_pair_group.fold_launches,
        "quantize_launches": pattern.quantize_scales.launches,
    }


def expected_counts(kernel, n, int8=False, programs=None) -> dict:
    """The launch counts of ``n`` windows ranked with ``kernel``: one
    launch per step of K1 (pallas: six SpMVs), of the pcsr kernel (six
    SpMVs), or of the pattern pair (four products; packed_blocked's
    through K8's own kernel, counted in blocked_launches too, and its
    fold launch) and K1 (the two call-graph terms); on every route one
    launch per step of the step kernel (K5); with ``int8`` (kind) one
    scale launch per window, for the first step (the step kernel takes
    every later step's scales); the two-launch step kernel never.
    ``programs``: the rank programs the windows ran in (stacked groups,
    K18: one launch of each kernel a step for the whole group; the
    SpMVs and products still count per window); default one a window."""
    counts = dict.fromkeys(("step_launches", "step_two_launch_launches", "k1_launches",
                            "k1_spmvs", "pcsr_launches",
                            "pcsr_spmvs", "pattern_launches", "pattern_products",
                            "blocked_launches", "fold_launches", "quantize_launches"), 0)
    g = n if programs is None else programs
    counts["step_launches"] = STEP_LAUNCHES * STEPS * g
    if kernel == "pallas":
        counts.update(k1_launches=STEPS * g, k1_spmvs=STEPS * SPMVS_PER_STEP * n)
    elif kernel == "pcsr":
        counts.update(pcsr_launches=STEPS * g, pcsr_spmvs=STEPS * SPMVS_PER_STEP * n)
    else:
        counts.update(k1_launches=STEPS * g, k1_spmvs=STEPS * SS_SPMVS_PER_STEP * n,
                      pattern_launches=STEPS * g, pattern_products=STEPS * 4 * n,
                      blocked_launches=STEPS * g if kernel == "packed_blocked" else 0,
                      fold_launches=STEPS * g if kernel == "packed_blocked" else 0,
                      quantize_launches=g if int8 else 0)
    return counts


def power_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"


def tiny_pattern_checks(torch, pattern, dev):
    """First launches of the pattern pair and the int8 scale launch:
    small ragged bitmaps (a last partial byte, three row tiles and three
    column tiles, and a part of one tile) in every precision, and in f32
    through K8's kernel, against the plain version on the CPU, bitwise.
    Returns the number of cases."""
    import numpy as np

    g = torch.Generator().manual_seed(1)
    n = 0
    # Each precision through the tile kernel, then f32 through K8's.
    for precision, blocked in [(p_, False) for p_ in pattern.PRECISIONS] + [("f32", True)]:
        parts = []
        for v, k in ((300, 1100), (7, 9)):
            m = (torch.rand((v, k), generator=g) < 0.4).numpy().astype(np.uint8)
            vecs = [torch.rand(n_, generator=g) for n_ in (k, v, v, k, v)]
            parts.append((torch.from_numpy(np.packbits(m, axis=1)), k, vecs))
        int8 = precision == "int8"

        def group(on):
            return pattern.pattern_group(
                [p.to(on) for p, _, _ in parts],
                [w[0].to(on) for _, _, w in parts],
                [w[1].to(on) for _, _, w in parts],
                [None if int8 else w[2].to(on) for _, _, w in parts],
                [k for _, k, _ in parts], blocked=blocked,
            )

        rvs = [w[3] for _, _, w in parts]
        svs = [w[4] for _, _, w in parts]
        on_dev = group(dev)
        d_rvs, d_svs = [r.to(dev) for r in rvs], [s_.to(dev) for s_ in svs]
        scales = pattern.quantize_scales(on_dev, d_rvs, d_svs) if int8 else None
        outs = pattern.pattern_pair_group(on_dev, d_rvs, d_svs, precision, scales)
        torch.cuda.synchronize()
        cpu = group("cpu")
        ref_scales = pattern.quantize_scales_plain(cpu, rvs, svs) if int8 else None
        if int8:
            check(torch.equal(scales.cpu(), ref_scales),
                  "tiny quantize_amax launch differs from its plain version")
            check(not on_dev.amax_scratch.any(), "quantize_amax left its scratch non-zero")
        ref = pattern.pattern_pair_plain(cpu, rvs, svs, precision, ref_scales)
        for got, want in zip(outs, ref):
            for a, b in zip(got, want):
                check((a is None and b is None) or torch.equal(a.cpu(), b),
                      f"tiny pattern-pair launch ({precision}) differs from its plain version")
        n += 1
    return n


def tiny_pcsr_checks(torch, spmv, dev, layout, x):
    """First launches of the pcsr kernel: the tiny K1 work list (a row of
    three chunks, empty rows) with ELL slabs of widths 4 and 1024 (rows of
    700, 257 and 256 live entries, empty rows), then 1 and 64, then 4 and
    512 (one row of 300 entries beside rows of 0 to 40), each slab wider
    than 32 slots read in both of its modes (8 threads a row by the row's
    length, and a warp a row), against the plain version on the CPU,
    bitwise. Returns the number of launches."""
    g = torch.Generator().manual_seed(2)

    def ell(n_rows, width, counts, slot):
        n = torch.randint(0, width + 1, (n_rows,), generator=g)
        n[: len(counts)] = torch.tensor(counts)
        ops = torch.randint(0, 40, (n_rows, width), generator=g, dtype=torch.int32)
        vals = torch.rand((n_rows, width), generator=g) * 0.99 + 0.01
        pad = torch.arange(width) >= n[:, None]
        return spmv.ell_part(ops.masked_fill(pad, 0), vals.masked_fill(pad, 0.0), slot)

    xs = [x, torch.rand(40, generator=g), torch.rand(40, generator=g)]
    rows = spmv.spmv_group([layout], (0,), (x.shape[0],))
    n = 0
    for slabs in ((ell(300, 4, (0, 4, 1), 1), ell(9, 1024, (700, 257, 256, 0, 1024), 2)),
                  (ell(70, 1, (0, 1), 2), ell(33, 64, (0, 64, 63), 1)),
                  (ell(40, 4, (4, 0), 1), ell(64, 512, (300, *(i % 41 for i in range(63))), 2))):
        for wide in (spmv.ELL_SHORT, spmv.ELL_WARP):
            slabs = tuple(e if e.mode == spmv.ELL_SLAB else e._replace(mode=wide) for e in slabs)
            cpu = spmv.PcsrGroup(rows, slabs, (0, 1, 2))
            on_dev = spmv.PcsrGroup(
                spmv.SpmvGroup(*(t.to(dev) if torch.is_tensor(t) else t for t in rows)),
                tuple(spmv.EllPart(*(t.to(dev) if torch.is_tensor(t) else t for t in e))
                      for e in slabs),
                cpu.order,
            )
            got = spmv.pcsr_spmv_group(on_dev, [v.to(dev) for v in xs])
            torch.cuda.synchronize()
            for a, b in zip(got, spmv.pcsr_spmv_group_plain(cpu, xs)):
                check(torch.equal(a.cpu(), b),
                      f"tiny pcsr launch (wide mode {wide}) differs from its plain version")
            n += 1
    return n


def tiny_step_checks(torch, pattern, dev):
    """First launches of the step kernel (K5): two partitions of 7 x 9
    and 300 x 1,100 elements (one block, and several blocks a vector)
    over chains of three steps, with the default configuration, without
    normalization, with a tol that freezes after the first step, with
    an empty partition, with the int8 scales (a tiny pattern group's
    weights), and with the grid cut to one block a vector (partitions of
    300 x 1,500 and 300 x 11,000), so that each thread takes 6 elements
    (the carry in registers) and 43 (past the register slots). Each
    through one window of the fused kernel, through one-step calls of it
    (``power_step``) and through the two-launch kernel, against the
    plain version on the card, bitwise. Returns the number of cases."""
    import numpy as np

    from microrank_tpu_torch.ops import step

    gen = torch.Generator(device=dev).manual_seed(2)
    g = torch.Generator().manual_seed(3)
    small, mid, wide = [(7, 9), (300, 1100)], [(300, 1500)] * 2, [(300, 11_000)] * 2
    n = 0
    for tol, normalize, empty, scales, sizes, max_blocks in (
            (None, True, (), False, small, None),
            (None, False, (), False, small, None),
            ("half", True, (), False, small, None),
            (1e-4, True, (1,), False, small, None),
            (None, True, (), True, small, None),
            (1e-30, True, (), True, mid, 4),
            (1e-30, True, (), True, wide, 4)):
        group = pattern.pattern_group(
            [torch.from_numpy(np.packbits((torch.rand((v, t), generator=g) < 0.4).numpy()
                                          .astype(np.uint8), axis=1)).to(dev) for v, t in sizes],
            [torch.rand(t, generator=g).to(dev) for _, t in sizes],
            [torch.rand(v, generator=g).to(dev) for v, _ in sizes],
            [None, None], [t for _, t in sizes],
        )
        products, carry, prefs = random_step_inputs(torch, gen, sizes, dev, empty)
        if tol == "half":
            plan = step.step_plan(prefs, 0.01, 0.85, None, True, step.step_scratch(dev))
            res = torch.zeros((2, 1), device=dev)
            step.power_step_plain(plan, products, carry, res, 0)
            tol = float(res.max()) / 2
        plan = step.step_plan(prefs, 0.01, 0.85, tol, normalize, step.step_scratch(dev),
                              group if scales else None)
        want = step_chain(torch, step.power_step_plain, plan, products, carry, 3, scales)
        for label, fn in (("window", None), ("power_step", step.power_step),
                          ("two_launch", step.power_step_two_launch)):
            got = step_chain(torch, fn, plan, products, carry, 3, scales, max_blocks)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"tiny step-kernel chain ({label}, tol={tol}, normalize={normalize}, "
                  f"empty={empty}, int8={scales}, max_blocks={max_blocks}) differs from its "
                  "plain version")
            check(not plan.scratch.any(), "the step kernel left its scratch non-zero")
        n += 1
    return n


def ptxas_all(report, kernel):
    """ptxas's lines for every kernel of a ``-Xptxas -v`` report whose
    name holds ``kernel``: its entry, properties (stack, spills) and
    registers."""
    lines = [ln.strip() for ln in report.splitlines()]
    return [lines[k: k + 4] for k, ln in enumerate(lines)
            if "Compiling entry function" in ln and kernel in ln]


def phase_env(torch, spmv, pattern, native):
    from microrank_tpu_torch.ops import step

    # Build the four libraries from the checkout's sources, in parallel.
    for lib in (spmv.LIB_PATH, pattern.LIB_PATH, step.LIB_PATH, native.LIB_PATH):
        lib.unlink(missing_ok=True)

    def timed(fn):
        t0 = time.perf_counter()
        report = fn()
        return time.perf_counter() - t0, report

    with ThreadPoolExecutor(4) as pool:
        f_cuda = pool.submit(timed, spmv.build_library)
        f_pattern = pool.submit(timed, pattern.build_library)
        f_step = pool.submit(timed, step.build_library)
        f_host = pool.submit(timed, native.build_library)
        cuda_s, ptxas = f_cuda.result()
        pattern_s, ptxas_pattern = f_pattern.result()
        step_s, ptxas_step = f_step.result()
        host_s, _ = f_host.result()
    spmv.load_library()
    pattern.load_library()
    step.load_library()

    # First launch: a tiny ragged matrix (empty rows, a 700-entry row of
    # three chunks, padding) against the plain version, before anything
    # big runs.
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    rows = torch.cat([torch.zeros(700, dtype=torch.int32),
                      torch.randint(0, 37, (300,), generator=g, dtype=torch.int32),
                      torch.zeros(30, dtype=torch.int32)])
    cols = torch.randint(0, 53, (1030,), generator=g, dtype=torch.int32)
    cols[-30:] = 0
    vals = torch.rand(1030, generator=g)
    vals[-30:] = 0.0
    x = torch.rand(53, generator=g)
    lay = spmv.row_layout(rows.to(dev), cols.to(dev), vals.to(dev), 37, 1000)
    y = spmv.coo_spmv(lay, x.to(dev))
    torch.cuda.synchronize()
    host_lay = spmv.row_layout(rows, cols, vals, 37, 1000)
    tiny_bitwise = bool(torch.equal(y.cpu(), spmv.coo_spmv_plain(host_lay, x)))
    check(tiny_bitwise, "tiny K1 launch differs from its plain version")
    n_pcsr = tiny_pcsr_checks(torch, spmv, dev, host_lay, x)
    n_pattern = tiny_pattern_checks(torch, pattern, dev)
    n_step = tiny_step_checks(torch, pattern, dev)
    step_cfg = step.kernel_config(dev)
    timers = timer_check(torch)
    return {
        "phase": "env",
        "device": torch.cuda.get_device_name(0),
        "device_count": torch.cuda.device_count(),
        "nvidia_smi": power_line(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
        "build_s": {"nvcc_coo_spmv": round(cuda_s, 3),
                    "nvcc_pattern_pair": round(pattern_s, 3),
                    "nvcc_power_step": round(step_s, 3),
                    "gxx_native": round(host_s, 3)},
        "ptxas": [ln.strip() for ln in ptxas.splitlines() if "ptxas" in ln],
        "ptxas_pattern_pair": [ln.strip() for ln in ptxas_pattern.splitlines()
                               if "ptxas" in ln],
        "ptxas_power_step": [ln.strip() for ln in ptxas_step.splitlines() if "ptxas" in ln],
        # K5's fused kernel: each instantiation's ptxas lines
        # (registers, spills), the register slots a thread holds across
        # the barrier, and the occupancy that sizes every window's
        # cooperative grid.
        "step_kernel": {**step_cfg._asdict(), "max_blocks": step_cfg.max_blocks,
                        "ptxas": ptxas_all(ptxas_step, "step_grid")},
        "tiny_launch_bitwise_vs_plain": tiny_bitwise,
        "tiny_pcsr_launches_bitwise_vs_plain": n_pcsr,
        "tiny_pattern_cases_bitwise_vs_plain": n_pattern,
        "tiny_step_chains_bitwise_vs_plain": n_step,
        "timer_check_1gib_copy": timers,
    }


def phase_data(args, workdir):
    from microrank_tpu_torch.native import load_span_table
    from microrank_tpu_torch.testing import SyntheticConfig, generate_case_with_spans

    t0 = time.perf_counter()
    case = generate_case_with_spans(
        SyntheticConfig(
            n_operations=args.ops,
            n_kinds=max(32, args.ops // 50),
            child_keep_prob=0.55,
            fault_latency_ms=60000.0,
            seed=0,
        ),
        target_spans=args.spans,
    )
    normal, abnormal = case.write_csvs(workdir)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    # First load parses the CSVs and leaves the interned sidecars the
    # runs below reuse.
    n_normal = load_span_table(normal).n_spans
    n_abnormal = load_span_table(abnormal).n_spans
    return case, normal, abnormal, {
        "phase": "data",
        "spans_target": args.spans,
        "operations": args.ops,
        "normal_spans": n_normal,
        "abnormal_spans": n_abnormal,
        "fault_pod_op": case.fault_pod_op,
        "generate_write_s": round(gen_s, 3),
        "parse_s": round(time.perf_counter() - t0, 3),
    }


def graph_shapes(graph):
    out = {}
    for name in ("normal", "abnormal"):
        p = getattr(graph, name)
        out[name] = {
            "V": int(p.cov_unique.shape[0]),
            "T_pad": int(p.kind.shape[0]),
            "E_pad": int(p.inc_op.shape[0]),
            "E": int(p.n_inc),
            "C_pad": int(p.ss_child.shape[0]),
            "C": int(p.n_ss),
            "traces": int(p.n_traces),
            "cols": int(p.n_cols),
            "cov_bits_bytes": int(p.cov_bits.size),
        }
    return out


def device_ms(torch, fn, reps):
    """Device time per call of ``fn`` (kernels and copies it issues),
    from torch.profiler's CUDA activity; None when the profiler records
    no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then records no device time
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            events = prof.key_averages()
        total_us = sum(getattr(e, "self_device_time_total", 0) for e in events)
        if total_us > 0:
            return total_us / reps / 1e3
    return None


def rank_device_fields(rank_device, rank_wall_ms):
    """The rank program's device time by torch.profiler and by CUDA
    events around the program queued behind a long device spin (an upper
    bound: where its launches outrun the stream's queue, its tail may
    wait on the host), each with its share of the program's wall time;
    and the program whole as ``rank_program_event_ms`` (the events'
    time) beside ``rank_program_host_ms`` (the host's time to issue it,
    behind the same spin)."""
    prof, (events, host) = rank_device
    out = {}
    for key, t in (("rank_device_ms", prof), ("rank_device_event_ms", events)):
        out[key] = None if t is None else round(t, 4)
        share = key.replace("_ms", "_busy_share")
        out[share] = None if t is None else round(t / rank_wall_ms, 4)
    out["rank_program_event_ms"] = events
    out["rank_program_host_ms"] = host
    return out


def window_breakdown(torch, cfg, normal, abnormal, start_iso):
    """One ranked window again, through the lane's own seams, one stage
    at a time with the device drained between stages: where a window's
    wall time goes, and how busy the device is while the rank program
    runs. Returns (host graph, resolved kernel, stage ms, device ms of
    the rank stage)."""
    import numpy as np

    from microrank_tpu_torch.native import load_span_table
    from microrank_tpu_torch.pipeline import TableRCA
    from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
    from microrank_tpu_torch.rank_backends.torch_cuda import (
        device_subset,
        fetch_rank_outputs,
        host_subset,
        rank_window_traced_core,
    )

    rca = TableRCA(cfg, device="cuda")
    rca.fit_baseline(load_span_table(normal))
    table = load_span_table(abnormal)
    w0 = int(np.datetime64(start_iso, "us").astype(np.int64))
    w1 = w0 + int(cfg.window.detect_minutes * 60_000_000)
    ms = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[name] = round((time.perf_counter() - t0) * 1e3, 3)
        return out

    mask, nrm, abn, _, rng = stage("detect", lambda: rca._detect_window(table, w0, w1))
    graph, _, kernel = stage(
        "build", lambda: rca.prepare_rank(table, mask, nrm, abn, rng)
    )
    dgraph = stage("h2d", lambda: graph_from_numpy(host_subset(graph, kernel), rca.device))
    dgraph = stage("layouts", lambda: device_subset(dgraph, kernel))

    def rank():
        return rank_window_traced_core(dgraph, cfg.pagerank, cfg.spectrum, kernel)

    outs = stage("rank_issue_and_run", rank)
    stage("fetch", lambda: fetch_rank_outputs(outs))
    rank_device = (device_ms(torch, rank, 3),
                   spin_event_host_ms(torch, rank, 3, PROGRAM_SPIN_CYCLES))
    return graph, kernel, ms, rank_device, dgraph


def budget_inequalities(graph, budget):
    """The two inequalities of the auto policy at a window's real shapes:
    bitmaps within a quarter of the budget (else pcsr), unpacked f32
    matrices within the budget (else packed_blocked)."""
    from microrank_tpu_torch.graph.build import packed_bits_bytes, packed_unpacked_bytes

    v_pad = int(graph.normal.cov_unique.shape[0])
    t_pads = [int(p.kind.shape[0]) for p in (graph.normal, graph.abnormal)]
    bits = packed_bits_bytes(v_pad, t_pads)
    unpacked = packed_unpacked_bytes(v_pad, t_pads)
    return {
        "budget": budget, "v_pad": v_pad, "t_pads": t_pads,
        "bitmap_bytes": bits, "unpacked_bytes": unpacked,
        "bitmap_bytes <= budget/4": bits <= budget // 4,
        "unpacked_bytes <= budget": unpacked <= budget,
    }


def phase_run(torch, spmv, pattern, case, normal, abnormal, collapse, kernel,
              budget=None, want=None, precision="f32"):
    """One run of the lane with ``kernel`` ("pallas", or "auto" resolving
    to ``want``, by default AUTO_KERNEL[collapse]) at ``budget`` (None:
    the default dense budget) and ``precision`` (kind_precision) on the
    card and on the CPU. Returns (host graph, launch counts of the warm
    CUDA run, the CUDA run's results, info)."""
    from microrank_tpu_torch.config import MicroRankConfig, PageRankConfig, RuntimeConfig
    from microrank_tpu_torch.pipeline import run_rca_native
    from microrank_tpu_torch.utils.ranking_compare import tie_aware_topk_agreement

    runtime = dict(kernel=kernel, collapse_kinds=collapse)
    if budget is not None:
        runtime["dense_budget_bytes"] = budget
    cfg = MicroRankConfig(
        pagerank=PageRankConfig(kind_precision=precision), runtime=RuntimeConfig(**runtime)
    )
    if want is None:
        want = kernel if kernel != "auto" else AUTO_KERNEL[collapse]
    int8 = precision == "int8" and want == "kind"
    tag = (f"kernel={kernel}, collapse={collapse}, precision={precision}, "
           f"budget={cfg.runtime.dense_budget_bytes}")
    walls, counts, res_gpu = [], [], None
    for _ in ("cold", "warm"):
        torch.cuda.synchronize()
        reset_counts(spmv, pattern)
        t0 = time.perf_counter()
        res_gpu = run_rca_native(normal, abnormal, cfg, device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts.append(read_counts(spmv, pattern))

    t0 = time.perf_counter()
    res_cpu = run_rca_native(normal, abnormal, cfg, device="cpu")
    cpu_s = time.perf_counter() - t0

    ranked = [r for r in res_gpu if r.ranking]
    check(ranked, f"{tag}: no window was ranked")
    kernels = sorted({r.kernel for r in ranked})
    check(kernels == [want], f"{tag}: ranked with {kernels}, want {want}")
    n = len(ranked)
    expect = expected_counts(want, n, int8)
    for c in counts:
        check(c == expect, f"{tag}: launch counts {c} in {n} ranked windows, want {expect}")
    top1 = ranked[0].ranking[0][0]
    check(top1 == case.fault_pod_op, f"{tag}: top-1 {top1} is not the fault {case.fault_pod_op}")
    rtol = RUN_RTOL_BF16 if want == "packed_bf16" else RUN_RTOL
    # int8: the top-5 at JAX's own int8 gate (tests/test_kind_kernel.py).
    top_k, exempt_last = (5, True) if int8 else (None, False)
    if int8:
        rtol = RUN_RTOL_INT8
    check(len(res_cpu) == len(res_gpu), "CPU and CUDA runs saw different windows")
    for rg, rc in zip(res_gpu, res_cpu):
        check(
            (rg.start, rg.anomaly, rg.n_normal, rg.n_abnormal, rg.kernel)
            == (rc.start, rc.anomaly, rc.n_normal, rc.n_abnormal, rc.kernel),
            f"window {rg.start}: detection or kernel differs between CUDA and CPU runs",
        )
        ok, why = tie_aware_topk_agreement(
            [n_ for n_, _ in rg.ranking], [s for _, s in rg.ranking],
            [n_ for n_, _ in rc.ranking], [s for _, s in rc.ranking],
            k=top_k or len(rg.ranking), rtol=rtol, exempt_last=exempt_last,
        )
        check(ok, f"window {rg.start}: CUDA vs CPU ranking: {why}")
        check(rg.rank_iterations == rc.rank_iterations, "n_iters differ")
        if rg.ranking:
            check(rg.ranking[0][0] == rc.ranking[0][0], "top-1 differs between CUDA and CPU")

    graph, _, stages, rank_device, dgraph = window_breakdown(
        torch, cfg, normal, abnormal, ranked[0].start
    )
    # The window through the plain step on the card: bitwise.
    plain_step = plain_step_check(torch, dgraph, cfg, want)
    del dgraph
    rank_wall = stages["rank_issue_and_run"]
    return graph, counts[-1], res_gpu, {
        "phase": "run",
        "kernel": kernel,
        "resolved_kernel": want,
        "kind_precision": precision,
        "collapse_kinds": collapse,
        "dense_budget": budget_inequalities(graph, cfg.runtime.dense_budget_bytes),
        "windows": len(res_gpu),
        "ranked": n,
        "kind_dedup": ranked[0].kind_dedup,
        "shapes": graph_shapes(graph),
        "top5": ranked[0].ranking[:5],
        "top1_is_fault": True,
        "launches_per_run": counts,
        "k1_launches_per_ranked_window": counts[-1]["k1_launches"] // n,
        "k1_spmvs_per_ranked_window": counts[-1]["k1_spmvs"] // n,
        "pcsr_launches_per_ranked_window": counts[-1]["pcsr_launches"] // n,
        "pattern_launches_per_ranked_window": counts[-1]["pattern_launches"] // n,
        "quantize_launches_per_ranked_window": counts[-1]["quantize_launches"] // n,
        "step_launches_per_ranked_window": counts[-1]["step_launches"] // n,
        "cuda_vs_cpu_tie_aware": True,
        "cuda_vs_cpu_rtol": rtol,
        "cuda_vs_cpu_top_k": top_k or "all",
        "rank_iterations": ranked[0].rank_iterations,
        "cuda_wall_s_per_window": {
            "cold": round(walls[0] / len(res_gpu), 4),
            "warm": round(walls[1] / len(res_gpu), 4),
        },
        "cuda_window_timings_ms": ranked[0].timings,
        "stage_ms": stages,
        **rank_device_fields(rank_device, rank_wall),
        "plain_step": plain_step,
        "cpu_wall_s": round(cpu_s, 4),
    }


def phase_replay_data(args, workdir):
    """bench.py's config-5 replay (``_ensure_batch_data``): every window
    faulted, from the port's own timeline generator, written and parsed
    as a user's dump would be. The timeline CSV is written one window at
    a time (the same bytes as one write), and the file's size after each
    window is kept: the follow phase grows its file by those byte
    ranges."""
    from microrank_tpu_torch.native import load_span_table
    from microrank_tpu_torch.testing import SyntheticConfig, generate_timeline_with_spans
    from microrank_tpu_torch.testing.synthetic import write_spans_csv

    n = args.replay_windows
    t0 = time.perf_counter()
    tl = generate_timeline_with_spans(
        SyntheticConfig(
            n_operations=args.ops,
            n_kinds=max(32, args.ops // 50),
            child_keep_prob=0.55,
            fault_latency_ms=60000.0,
            seed=0,
        ),
        args.spans,
        n,
        list(range(n)),  # every window carries the fault
    )
    (workdir / "replay").mkdir()
    normal, abnormal = workdir / "replay" / "normal.csv", workdir / "replay" / "abnormal.csv"
    write_spans_csv(tl.normal, normal, tl.n_operations)
    offsets = []
    for i, window in enumerate(tl.windows):
        write_spans_csv(window, abnormal, tl.n_operations, append=i > 0)
        offsets.append(abnormal.stat().st_size)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    normal_table = load_span_table(normal, cache=False)
    table = load_span_table(abnormal, cache=False)
    return tl, normal_table, table, (abnormal, offsets), {
        "windows": n,
        "spans_per_window_target": args.spans,
        "timeline_spans": table.n_spans,
        "normal_spans": normal_table.n_spans,
        "generate_write_s": round(gen_s, 3),
        "parse_s": round(time.perf_counter() - t0, 3),
    }


def kernel_busy_share(torch, workdir, fn):
    """Run ``fn`` once under torch.profiler (device activity only) and
    return (wall s, union of the kernel intervals over that wall time);
    the share is None when the profiler recorded no kernel."""
    from torch.profiler import ProfilerActivity, profile

    trace = workdir / "replay_trace.json"
    for _ in range(3):  # the profiler now and then records no device time
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        prof.export_chrome_trace(str(trace))
        spans = sorted(
            (e["ts"], e["ts"] + e["dur"])
            for e in json.loads(trace.read_text())["traceEvents"]
            if e.get("cat") == "kernel"
        )
        trace.unlink()
        if spans:
            busy_us, end = 0.0, float("-inf")
            for lo, hi in spans:
                busy_us += max(0.0, hi - max(lo, end))
                end = max(end, hi)
            return wall, busy_us / 1e6 / wall
    return wall, None


def _median(values):
    values = sorted(values)
    return values[len(values) // 2] if values else None


def _mean(values):
    return sum(values) / len(values)


def replay_config(tl, precision="f32", **runtime):
    """The replay's config: each generated window exactly (detect = its
    span, skip = 0), kind_precision ``precision``."""
    from microrank_tpu_torch.config import (
        MicroRankConfig,
        PageRankConfig,
        RuntimeConfig,
        WindowConfig,
    )

    return MicroRankConfig(
        window=WindowConfig(detect_minutes=tl.window_minutes, skip_minutes=0.0),
        pagerank=PageRankConfig(kind_precision=precision),
        runtime=RuntimeConfig(**runtime),
    )


def metrics_gates(tag, out, n_ranked, admitted):
    """The metrics a run wrote, read back as ``cli stats`` reads them:
    ``metrics.json`` in ``out`` holds the ranked windows, one convergence
    sample per ranked window and the admitted rows, and the journal's
    ``run_end`` carries ``telemetry``."""
    from microrank_tpu_torch.obs import JOURNAL_NAME, read_journal

    snap = json.loads((out / "metrics.json").read_text())["metrics"]

    def samples(name):
        return snap[name]["samples"]

    ranked = sum(s["value"] for s in samples("microrank_windows_total")
                 if s["labels"]["outcome"] == "ranked")
    iters = sum(s["count"] for s in samples("microrank_rank_iterations"))
    admitted_rows = sum(s["value"] for s in samples("microrank_ingest_admitted_total"))
    check(ranked == n_ranked, f"{tag}: windows_total ranked {ranked}, want {n_ranked}")
    check(iters == n_ranked, f"{tag}: rank_iterations count {iters}, want {n_ranked}")
    check(admitted_rows == admitted,
          f"{tag}: ingest admitted {admitted_rows}, admit_table kept {admitted}")
    end = read_journal(out / JOURNAL_NAME)[-1]
    check(end["event"] == "run_end" and "telemetry" in end,
          f"{tag}: the journal's run_end has no telemetry")
    return {
        "windows_total_ranked": ranked,
        "rank_iterations_count": iters,
        "ingest_admitted": admitted_rows,
        "run_end_telemetry": end["telemetry"],
        "series_sampled": sorted(k for k, v in snap.items() if v["samples"]),
    }


def ranked_timings(results):
    """The first ranked window's timings (batch's shared keys)."""
    return next((r.timings for r in results if r.ranking), {})


def ranking_agreement(a, b, rtol, int8=False):
    """Two rankings [(name, score), ...] tie-aware at ``rtol``, the same
    length and top-1; ``int8``: the top-5 at RUN_RTOL_INT8, the last
    place exempt (JAX's own int8 gate, as phase_run's)."""
    from microrank_tpu_torch.utils.ranking_compare import tie_aware_topk_agreement

    if len(a) != len(b) or (a and a[0][0] != b[0][0]):
        return False, "lengths or top-1 differ"
    return tie_aware_topk_agreement(
        [n for n, _ in a], [x for _, x in a], [n for n, _ in b], [x for _, x in b],
        k=min(5, len(a)) if int8 else len(a), rtol=RUN_RTOL_INT8 if int8 else rtol,
        exempt_last=int8,
    )


def replay_groups(mode, n):
    """The sizes of the stacked groups a replay mode ranks ``n`` windows
    in: all of them in one (batch), groups of dispatch_batch_windows, or
    one program a window."""
    if mode == "batch":
        return [n]
    k = REPLAY_MODES[mode].get("dispatch_batch_windows", 1)
    return [min(k, n - i) for i in range(0, n, k)]


def replay_mode(torch, spmv, pattern, tl, normal_table, table, mode, workdir):
    """One mode of ``TableRCA.run`` on the card over the whole timeline:
    a warm pass with a sink (records, cursor, journal; in the default
    mode also the metrics snapshot the CLI writes, into a fresh registry,
    and its gates), three timed passes without one (as bench.py's
    ``_run_replay``), their launches counted per pass (a stacked mode's
    per group: 25 launches of each kernel a group), then one pass under
    the profiler for the device's busy share. Returns (rca, warm
    results, launch counts of the last timed pass, info)."""
    import numpy as np

    from microrank_tpu_torch.config import IngestConfig
    from microrank_tpu_torch.graph.table_ops import window_rows
    from microrank_tpu_torch.ingest import admit_table
    from microrank_tpu_torch.obs import JOURNAL_NAME, MetricsRegistry, read_journal, set_registry
    from microrank_tpu_torch.obs.metrics import ensure_catalog
    from microrank_tpu_torch.pipeline import TableRCA

    precision = REPLAY_PRECISION.get(mode, "f32")
    cfg = replay_config(tl, precision, **REPLAY_MODES[mode])
    tag = f"replay/{mode}"
    batch = mode == "batch"
    with_metrics = mode == "default"
    if with_metrics:
        registry = MetricsRegistry()
        set_registry(registry)
    rca = TableRCA(cfg, device="cuda")
    rca.fit_baseline(normal_table)

    streams = []
    entry = "launch_program" if mode in STACKED_MODES else "launch_rank"
    launch = getattr(rca, entry)

    def spy(*a):  # which stream the launch issues on, once
        streams.append(torch.cuda.current_stream())
        setattr(rca, entry, launch)
        return launch(*a)

    setattr(rca, entry, spy)
    out = workdir / f"replay_{mode}"
    warm = rca.run(table, out_dir=out, batch_windows=batch)
    metrics = None
    if with_metrics:
        # What `cli run` writes beside the results when telemetry is on.
        ensure_catalog()
        registry.write_snapshot(out)
        kept = sum(admit_table(t, IngestConfig())[0].n_spans for t in (normal_table, table))
        metrics = metrics_gates(tag, out, sum(1 for r in warm if r.ranking), kept)
        set_registry(MetricsRegistry())
    check(len(streams) == 1, f"{tag}: {entry} was not reached")
    on_default = streams[0] == torch.cuda.default_stream()
    if cfg.runtime.async_dispatch and not batch:  # batch ranks after the loop's workers
        check(not on_default, f"{tag}: the stage worker launched on the default stream")
    ranked = [r for r in warm if r.ranking]
    check(len(ranked) == len(tl.windows),
          f"{tag}: {len(ranked)} of {len(tl.windows)} faulted windows ranked")
    check(all(r.skipped_reason == "empty_window" for r in warm if not r.ranking),
          f"{tag}: an unranked window that is not empty")
    for r in ranked:
        check(r.ranking[0][0] == tl.fault_pod_op,
              f"{tag}: window {r.start} top-1 {r.ranking[0][0]} is not {tl.fault_pod_op}")
        check(r.kernel == "kind", f"{tag}: window {r.start} ranked with {r.kernel}")
    check(not (out / "cursor.json").exists(), f"{tag}: a clean run left its cursor")
    events = read_journal(out / JOURNAL_NAME)
    n_win = sum(e["event"] == "window" for e in events)
    check(n_win == len(warm), f"{tag}: {n_win} journal window events for {len(warm)} windows")
    check([e["event"] for e in events[:1] + events[-1:]] == ["run_start", "run_end"],
          f"{tag}: the journal does not open with run_start and close with run_end")

    n = len(ranked)
    groups = replay_groups(mode, n)
    expect = expected_counts("kind", n, int8=precision == "int8", programs=len(groups))
    if mode in STACKED_MODES:
        check([r.timings.get("chunk_windows", n) for r in ranked]
              == [g for g in groups for _ in range(g)],
              f"{tag}: windows not ranked in groups of {groups}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, timed, stage_sums = [], [], []
    for _ in range(3):
        torch.cuda.synchronize()
        reset_counts(spmv, pattern)
        t0 = time.perf_counter()
        res = rca.run(table, batch_windows=batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts = read_counts(spmv, pattern)
        check(counts == expect, f"{tag}: launch counts {counts} in {n} ranked windows, want {expect}")
        check([(r.start, r.ranking, r.rank_iterations) for r in res]
              == [(r.start, r.ranking, r.rank_iterations) for r in warm],
              f"{tag}: a timed pass differs from the warm pass")
        timed.extend(res)
        # The main thread's per-window stages (batch's shared build and
        # rank counted once); the rest of a pass is per-run work
        # (admission of the whole table, its bounds).
        shared = {"build", "rank_batched"}
        stage_sums.append(sum(
            v for r in res for k, v in r.timings.items()
            if not k.endswith("_windows") and k not in shared
        ) + sum(v for k, v in ranked_timings(res).items() if k in shared))
    peak = torch.cuda.max_memory_allocated()
    prof_wall, busy = kernel_busy_share(
        torch, workdir, lambda: rca.run(table, batch_windows=batch)
    )

    replay_s = _median(walls)
    median_pass = walls.index(replay_s)
    spans = sum(
        int(window_rows(table, int(np.datetime64(r.start, "us").astype(np.int64)),
                        int(np.datetime64(r.end, "us").astype(np.int64))).sum())
        for r in ranked
    )
    keys = ("detect", "rank_dispatch", "rank_wait", "bulk_fetch_ms", "chunk_fetch_ms",
            "build", "rank_batched")
    medians = {
        k: _median([r.timings[k] for r in timed if r.ranking and k in r.timings])
        for k in keys
    }
    return rca, warm, counts, {
        "mode": mode,
        "runtime": REPLAY_MODES[mode],
        "kind_precision": precision,
        "windows": len(warm),
        "ranked": n,
        "top1_is_fault": True,
        "kernel": "kind",
        "spans_ranked": spans,
        "replay_ms": round(replay_s * 1e3, 3),
        "replay_ms_passes": [round(w * 1e3, 3) for w in walls],
        "window_stage_ms_sum": round(stage_sums[median_pass], 3),
        "ms_per_window": round(replay_s * 1e3 / n, 3),
        "spans_per_s": round(spans / replay_s, 1),
        "device_busy_share": None if busy is None else round(busy, 4),
        "profiled_pass_ms": round(prof_wall * 1e3, 3),
        "peak_device_memory_bytes": peak,
        "window_timing_medians_ms": {k: v for k, v in medians.items() if v is not None},
        "queue_depths": [r.queue_depth for r in warm if r.ranking],
        "groups": groups,
        "launches_per_pass": counts,
        "stage_stream_is_default": on_default,
        "metrics": metrics,
    }


def phase_replay(torch, spmv, pattern, args, workdir):
    """The replay phase: ``TableRCA.run`` over bench.py's config-5
    timeline in the sync, default (async stream, depth 2) and async bulk
    modes, each held bitwise to the sync run, and a run resumed from a
    cursor saved after window 2 held bitwise to the tail."""
    from microrank_tpu_torch.pipeline.checkpoint import WindowCursor

    from microrank_tpu_torch.config import IngestConfig
    from microrank_tpu_torch.ingest import admit_table
    from microrank_tpu_torch.pipeline import TableRCA

    t0 = time.perf_counter()
    tl, normal_table, table, timeline_csv, data = phase_replay_data(args, workdir)
    # What every run() does once before its first window: admission of
    # the whole timeline table.
    admit_ms = []
    for _ in range(3):
        t1 = time.perf_counter()
        admit_table(table, IngestConfig(), source="table")
        admit_ms.append((time.perf_counter() - t1) * 1e3)
    launches, infos, warm, records = {}, {}, {}, {}
    rca = None
    for mode in REPLAY_MODES:
        rca_mode, res, counts, info = replay_mode(
            torch, spmv, pattern, tl, normal_table, table, mode, workdir
        )
        launches[f"replay/{mode}"] = counts
        infos[mode], warm[mode] = info, res
        lines = (workdir / f"replay_{mode}" / "windows.jsonl").read_text().splitlines()
        records[mode] = [
            {k: rec.get(k) for k in ("start", "anomaly", "skipped_reason", "ranking")}
            for rec in map(json.loads, lines)
        ]
        if mode == "default":
            rca = rca_mode
    ref = [(r.start, r.ranking, r.rank_iterations) for r in warm["sync"]]
    for mode in ("default", "bulk"):
        got = [(r.start, r.ranking, r.rank_iterations) for r in warm[mode]]
        check(got == ref, f"replay/{mode}: rankings are not bitwise the sync run's")
        check(records[mode] == records["sync"],
              f"replay/{mode}: windows.jsonl records differ from the sync run's")
    # The per-window int8 run (sync) that the int8 chunked mode is held to.
    int8_rca = TableRCA(replay_config(tl, "int8", **REPLAY_MODES["sync"]), device="cuda")
    int8_rca.fit_baseline(normal_table)
    int8_ref = int8_rca.run(table)
    # The stacked modes: the same windows, iterations and top-1, the
    # rankings tie-aware at rtol 1e-5 (int8: the top-5 at its gate)
    # against the sync run of their precision; whether they are bitwise
    # is reported (a stacked window's preference sums run over the
    # group's padded trace axis).
    for mode in STACKED_MODES:
        got = warm[mode]
        int8 = REPLAY_PRECISION.get(mode) == "int8"
        base = int8_ref if int8 else warm["sync"]
        check([(r.start, r.rank_iterations) for r in got]
              == [(r.start, r.rank_iterations) for r in base],
              f"replay/{mode}: windows or iterations differ from the per-window run's")
        for a, b in zip(got, base):
            ok, why = ranking_agreement(a.ranking, b.ranking, RUN_RTOL, int8)
            check(ok, f"replay/{mode}: window {a.start}: {why}")
        strip = [{k: v for k, v in rec.items() if k != "ranking"} for rec in records[mode]]
        check(strip == [{k: v for k, v in rec.items() if k != "ranking"}
                        for rec in records["sync"]],
              f"replay/{mode}: windows.jsonl records differ from the sync run's")
        infos[mode]["rankings_bitwise_vs_per_window"] = (
            [(r.start, r.ranking, r.rank_iterations) for r in got]
            == [(r.start, r.ranking, r.rank_iterations) for r in base]
        )
        infos[mode]["rankings_tie_aware_vs_per_window"] = (
            "top-5 at 5e-2 (int8)" if int8 else "all at 1e-5")
        infos[mode]["per_window_run"] = "sync int8" if int8 else "sync"
    int8_one = [r for r in int8_ref if r.ranking]
    check(all(r.kernel == "kind" and r.ranking[0][0] == tl.fault_pod_op for r in int8_one),
          "replay: the per-window int8 run does not rank every window with kind, fault first")

    # Resume (default mode): a cursor saved after window 2 reruns the rest.
    k = min(2, len(warm["sync"]) - 1)
    out = workdir / "replay_resume"
    WindowCursor(out / "cursor.json").save(warm["sync"][k].start)
    resumed = rca.run(table, out_dir=out, resume=True)
    check([(r.start, r.ranking, r.rank_iterations) for r in resumed] == ref[k:],
          f"replay: the run resumed after window {k} is not bitwise windows {k + 1}-")
    return (tl, normal_table, table, timeline_csv), warm["sync"], launches, {
        "phase": "replay",
        "data": data,
        "fault_pod_op": tl.fault_pod_op,
        "admit_table_ms": round(_median(admit_ms), 3),
        "modes": infos,
        "rankings_bitwise_vs_sync": True,  # default and bulk; the stacked modes' in modes
        "sink_records_equal": True,
        "resumed_after_window": k,
        "resumed_bitwise": True,
        "phase_s": round(time.perf_counter() - t0, 3),
    }


def stacked_kernel_checks(torch, spmv, pattern, tag, card, host, singles=None,
                          precision="f32"):
    """One step's window-axis kernels of a stacked group, on random
    inputs: K1 over the stacked work list (pallas), the pcsr step over
    its work list and its slabs of B windows' rows (pcsr), or the pattern
    pair's window grid (kind, packed; K8 and its fold for packed_blocked;
    int8 after ``quantize_amax``'s [B, 4] scales) then K1 over the
    call-graph terms, bitwise their plain versions (computed on the CPU
    from ``host``, the same group built there; or, with ``singles``, the
    group's windows launched one by one, whose kernels other phases hold
    to the plain version), then bitwise over 50 launches with every
    arrival counter and amax slot back at 0. Returns the fields of the
    report."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    b = card.normal.kind.shape[0]
    dev = torch.device("cuda")
    svs = [torch.rand((b, p.cov_unique.shape[-1]), generator=gen, device=dev)
           for p in (card.normal, card.abnormal)]
    rvs = [torch.rand((b, p.kind.shape[-1]), generator=gen, device=dev)
           for p in (card.normal, card.abnormal)]
    pair = card.pattern_group
    pcsr = isinstance(card.spmv_group, spmv.PcsrGroup)
    prec = "bf16" if tag.endswith("packed_bf16") else precision

    def launch(g, r, v):
        """The step's kernels of group (or window) ``g`` on (rvs, svs)."""
        if g.pattern_group is None:
            six = spmv.pcsr_spmv_group if pcsr else spmv.coo_spmv_group
            return list(six(g.spmv_group, (r[0], v[0], r[1], v[1])))
        scales = pattern.quantize_scales(g.pattern_group, r, v) if prec == "int8" else None
        outs = pattern.pattern_pair_group(g.pattern_group, r, v, prec, scales)
        xs = [sv if x is None else x for sv, (_, _, x) in zip(v, outs)]
        return ([] if scales is None else [scales]) + [
            t for o in outs for t in o if t is not None] + list(
            spmv.coo_spmv_group(g.spmv_group, xs))

    first = [t.clone() for t in launch(card, rvs, svs)]
    torch.cuda.synchronize()
    if singles is None:
        want = launch(host, [x.cpu() for x in rvs], [x.cpu() for x in svs])
    else:
        rows = [launch(one, [x[w].contiguous() for x in rvs], [x[w].contiguous() for x in svs])
                for w, one in enumerate(singles)]
        want = [torch.stack([row[i] for row in rows]) for i in range(len(rows[0]))]
    torch.cuda.synchronize()
    diffs = [float((a.cpu() - w.cpu()).abs().max()) if a.numel() else 0.0
             for a, w in zip(first, want)]
    bitwise = all(torch.equal(bits(torch, a.cpu()), bits(torch, w.cpu()))
                  for a, w in zip(first, want))
    check(bitwise, f"{tag}: a window-axis kernel differs from its plain version")
    for _ in range(REPEATS):
        again = launch(card, rvs, svs)
        check(all(torch.equal(bits(torch, a), bits(torch, f)) for a, f in zip(again, first)),
              f"{tag}: not bitwise repeatable over {REPEATS} launches")
    torch.cuda.synchronize()
    work = card.spmv_group.rows if pcsr else card.spmv_group
    check(not bool(work.counters.any()), f"{tag}: K1's counters left non-zero")
    check(pair is None or not any(bool(p.counters.any()) for p in pair.parts),
          f"{tag}: the pair's counters left non-zero")
    check(pair is None or not bool(pair.amax_scratch.any()),
          f"{tag}: quantize_amax left its scratch non-zero")
    return {
        "kernels_bitwise_plain": True,
        "plain_from": "cpu" if singles is None else "the windows one by one",
        "kernels_repeatable": REPEATS,
        "max_abs_err": max(diffs),
    }


def program_bound(spmv, card, int8=False):
    """(bytes, bytes ms) of a rank program's 25 steps on a staged graph
    (one window or a stacked group): per step the bytes its kernels must
    move, each input read once and each output written once, at 3.35
    TB/s: K1's or the pcsr step's live entries (column and value), x read
    and y written; the ELL slabs' live entries, x and y; the pattern
    pairs' bitmaps [V, ceil(K/8)] with their vectors (``pattern_bound``'s
    bytes, no set-cell count needed); K5's products, pref and carry
    (``step_bound``); int8's four scales. The set-up, the epilogue and
    the first step's scale launch are left out (once a program)."""
    b = card.normal.kind.shape[0] if card.normal.kind.dim() == 2 else 1
    group = card.spmv_group
    work = group.rows if isinstance(group, spmv.PcsrGroup) else group
    live = int((work.items[:, 3] - work.items[:, 2]).sum())
    nbytes = 8 * live + 4 * sum(work.n_x) + 4 * sum(work.n_rows)
    if isinstance(group, spmv.PcsrGroup):
        for e in group.ell:
            n = int((e.vals != 0).sum())
            nbytes += 8 * n + 4 * b * card.normal.cov_unique.shape[-1] + 4 * e.ops.shape[0]
    if card.pattern_group is not None:
        nbytes += b * pattern_bound(card.pattern_group, [0] * len(card.pattern_group.parts))[0]
        nbytes += 16 * b if int8 else 0
    sizes = [(int(p.cov_unique.shape[-1]), int(p.kind.shape[-1]))
             for p in (card.normal, card.abnormal)]
    nbytes += b * step_bound(sizes)[0]
    total = STEPS * nbytes
    return total, total / HBM_BYTES_PER_S * 1e3


def stacked_program(torch, spmv, pattern, tag, card, singles, kernel, cfg, timed=True):
    """The stacked rank program (K18) on the card, as the lane issues a
    group: its launches counted (25 of each kernel of the route for the
    whole group; int8 one scale launch), its outputs held to each
    window's own program (the same n_valid and n_iters, the ranking
    tie-aware at rtol 1e-5, int8 the top-5 at 5e-2; bitwise reported),
    its steps (K5's group kernel, int8 with its [B, 4] scales) through
    the plain step on the card bitwise (``plain_step_check``); with
    ``timed``, host issue and device
    time (CUDA events behind a ~100 ms spin, the device drained after
    each call) of the stacked program and of the windows' own programs,
    each window's timed alone and the B summed, in turns (windows,
    stacked, stacked, windows), per program and per window."""
    from microrank_tpu_torch.rank_backends import torch_cuda as tc

    b = len(singles)

    def program(dg):
        return lambda: tc.pack_rank_outputs(
            tc.rank_window_traced_core(dg, cfg.pagerank, cfg.spectrum, kernel))

    program(card)()
    torch.cuda.synchronize()
    reset_counts(spmv, pattern)
    packed = program(card)()
    torch.cuda.synchronize()
    counts = read_counts(spmv, pattern)
    int8 = kernel == "kind" and cfg.pagerank.kind_precision == "int8"
    expect = expected_counts(kernel, b, int8, programs=1)
    check(counts == expect, f"{tag}: launch counts {counts}, want {expect}")
    got = tc.unpack_rank_outputs(packed)
    bitwise = True
    for w, one in enumerate(singles):
        want = tc.unpack_rank_outputs(program(one)())
        n = want[2]
        check((int(got[2][w]), int(got[4][w])) == (n, want[4]),
              f"{tag}: window {w}: n_valid / n_iters differ from its own program's")
        ok, why = ranking_agreement(list(zip(got[0][w][:n].tolist(), got[1][w][:n].tolist())),
                                    list(zip(want[0][:n].tolist(), want[1][:n].tolist())),
                                    RUN_RTOL, int8)
        check(ok, f"{tag}: window {w}: {why}")
        bitwise = bitwise and all(
            x.tobytes() == y.tobytes()
            for x, y in ((got[0][w][:n], want[0][:n]), (got[1][w][:n], want[1][:n]),
                         (got[3][w], want[3]))
        )
    bound_bytes, bound_ms = program_bound(spmv, card, int8)
    out = {
        "windows": b,
        "launches": counts,
        "bitwise_vs_window_programs": bitwise,
        "plain_step": plain_step_check(torch, card, cfg, kernel),
        "bound_bytes": bound_bytes,
        "bound_ms": round(bound_ms, 6),
        "bound_by": "bytes",
    }
    if not timed:
        return out, counts

    def timed_ms(dg):
        return spin_event_host_ms(torch, program(dg), 5, PROGRAM_SPIN_CYCLES, settle=True)

    turns = {"stacked": [], "windows": []}
    for which in ("windows", "stacked", "stacked", "windows"):
        if which == "stacked":
            turns[which].append(timed_ms(card))
        else:
            each = [timed_ms(one) for one in singles]
            turns[which].append((sum(e for e, _ in each), sum(h for _, h in each)))
    for which, vals in turns.items():
        ev = _mean([v[0] for v in vals])
        host = _mean([v[1] for v in vals])
        out[which] = {
            "event_ms": round(ev, 4), "host_issue_ms": round(host, 4),
            "event_ms_per_window": round(ev / b, 4),
            "host_issue_ms_per_window": round(host / b, 4),
            "turns": [[round(e, 4), round(h, 4)] for e, h in vals],
        }
    return out, counts


def phase_batched(torch, spmv, pattern, replay, windows, graphs):
    """K18, the stacked rank program, on the card: groups of B = 1, 2, 4
    and 6 of the replay's config-5 kind windows (each window's graph as
    ``prepare_rank`` builds it, stacked by ``parallel.stack_window_graphs``),
    the same windows with ``kind_precision="int8"`` at B = 2 and 6, and
    groups of the config-5 window stacked twice for ``pallas`` (collapse
    off), ``packed_bf16`` (auto, collapse off), ``packed_blocked`` (auto
    at 64 MiB) and ``pcsr`` (auto at 16 MiB). Each group: its
    window-axis kernels bitwise their plain versions over 50 launches
    (``stacked_kernel_checks``) and its program held to the windows' own
    (``stacked_program``); the kind groups and the int8 group of 6 timed
    against the per-window programs in turns."""
    import numpy as np

    from microrank_tpu_torch.parallel import stack_window_graphs
    from microrank_tpu_torch.pipeline import TableRCA
    from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
    from microrank_tpu_torch.rank_backends.torch_cuda import (
        device_subset,
        divide_block_budget,
        host_subset,
    )

    from microrank_tpu_torch.ingest import admit_table

    t0 = time.perf_counter()
    tl, normal_table, table, _ = replay
    cfg = replay_config(tl)
    rca = TableRCA(cfg, device="cuda")
    rca.fit_baseline(normal_table)
    table, _ = admit_table(table, cfg.ingest, source="table")  # as run() does first
    dev = torch.device("cuda")

    def us(iso):
        return int(np.datetime64(iso, "us").astype(np.int64))

    host = []
    for r in (r for r in windows if r.ranking):
        mask, nrm, abn, _, row_range = rca._detect_window(table, us(r.start), us(r.end))
        graph, _, kernel = rca.prepare_rank(table, mask, nrm, abn, row_range)
        check(kernel == "kind", f"batched: window {r.start} resolved to {kernel}")
        host.append(host_subset(graph, "kind"))

    def staged(g, kernel, device=dev):
        return device_subset(graph_from_numpy(g, device), kernel)

    singles = [staged(g, "kind") for g in host]
    launches, out = {}, {"phase": "batched", "kind": {}}
    for b in BATCH_SIZES:
        if b > len(host):
            continue
        stack = stack_window_graphs(host[:b])
        card = staged(stack, "kind")
        tag = f"batched/kind/{b}"
        info, counts = stacked_program(torch, spmv, pattern, tag, card, singles[:b], "kind", cfg)
        launches[tag] = counts
        if b == max(x for x in BATCH_SIZES if x <= len(host)):
            info.update(stacked_kernel_checks(torch, spmv, pattern, tag, card,
                                              staged(stack, "kind", "cpu")))
        info["trace_pads"] = [int(card.normal.kind.shape[-1]), int(card.abnormal.kind.shape[-1])]
        out["kind"][str(b)] = info
        del card
    # kind_precision="int8": one quantize_amax launch a group, the pair
    # and K5 with [B, 4] scales, each window's own.
    cfg8 = replay_config(tl, "int8")
    out["kind_int8"] = {}
    for b in (2, 6):
        if b > len(host):
            continue
        stack = stack_window_graphs(host[:b])
        card = staged(stack, "kind")
        tag = f"batched/kind_int8/{b}"
        info, counts = stacked_program(torch, spmv, pattern, tag, card, singles[:b], "kind",
                                       cfg8, timed=b == 6)
        launches[tag] = counts
        info.update(stacked_kernel_checks(torch, spmv, pattern, tag, card,
                                          staged(stack, "kind", "cpu"), precision="int8"))
        out["kind_int8"][str(b)] = info
        del card
    # The config-5 window stacked twice on the routes past the dense
    # budget too. The plain versions: on the CPU (pallas, pcsr) or the
    # window's own launches (packed_bf16, packed_blocked: the pattern
    # phase holds those to the CPU).
    for kernel, key, plain_on_cpu in (("pallas", "pallas/off", True),
                                      ("packed_bf16", "auto/off", False),
                                      ("packed_blocked", "auto/packed_blocked", False),
                                      ("pcsr", "auto/pcsr", True)):
        one = host_subset(graphs[key], kernel)
        single = staged(one, kernel)
        t1 = time.perf_counter()
        stack = stack_window_graphs([one, one])
        stack_ms = (time.perf_counter() - t1) * 1e3
        gcfg = cfg.replace(pagerank=divide_block_budget(cfg.pagerank, kernel, 2))
        card = device_subset(graph_from_numpy(stack, dev), kernel,
                             gcfg.pagerank.packed_block_bytes)
        tag = f"batched/{kernel}/2"
        info, counts = stacked_program(torch, spmv, pattern, tag, card, [single, single],
                                       kernel, gcfg, timed=False)
        launches[tag] = counts
        if plain_on_cpu:
            host_card = device_subset(graph_from_numpy(stack, "cpu"), kernel,
                                      gcfg.pagerank.packed_block_bytes)
            info.update(stacked_kernel_checks(torch, spmv, pattern, tag, card, host_card))
        else:
            info.update(stacked_kernel_checks(torch, spmv, pattern, tag, card, None,
                                              [single, single]))
        info["stack_host_ms"] = round(stack_ms, 3)
        out[kernel] = info
        del card, single
        torch.cuda.empty_cache()
    out["phase_s"] = round(time.perf_counter() - t0, 3)
    return launches, out


def phase_policy(torch, spmv, pattern, normal, abnormal, workdir, empty_policy_dir):
    """The tuned policy on the card: a ``policy.json`` in the JAX
    package's schema (written here: the card's machine has no JAX) that
    tunes the config-5 window's workload profile to ``method="ochiai"``,
    found through ``MICRORANK_POLICY_DIR``; ``run_rca_native`` must give
    bitwise the ranking of an explicit ``SpectrumConfig(method="ochiai")``
    run (no policy), and count one "applied" policy event."""
    import os

    from microrank_tpu_torch.config import IngestConfig, MicroRankConfig, SpectrumConfig
    from microrank_tpu_torch.graph.table_ops import compute_slo_from_table
    from microrank_tpu_torch.ingest import admit_table
    from microrank_tpu_torch.native import load_span_table
    from microrank_tpu_torch.obs import MetricsRegistry, set_registry
    from microrank_tpu_torch.pipeline import run_rca_native
    from microrank_tpu_torch.scenarios import policy

    # The profile as the table lane computes it: the admitted normal
    # table's span count and op cardinality, dedup unknown ("low").
    table, _ = admit_table(load_span_table(normal), IngestConfig())
    vocab, _ = compute_slo_from_table(table)
    key = policy.profile_from_counts(table.n_spans, len(vocab)).key()
    pdir = workdir / "policy"
    pdir.mkdir()
    (pdir / policy.POLICY_NAME).write_text(json.dumps({
        "version": policy.POLICY_VERSION,
        "profile_schema": policy.PROFILE_SCHEMA,
        "matrix_seed": None,
        "profiles": {key: {"method": "ochiai", "kernel": "auto", "pad_policy": "pow2q"}},
    }))
    registry = MetricsRegistry()
    set_registry(registry)
    os.environ["MICRORANK_POLICY_DIR"] = str(pdir)
    try:
        reset_counts(spmv, pattern)
        tuned = run_rca_native(normal, abnormal, MicroRankConfig(), device="cuda")
        counts = read_counts(spmv, pattern)
        events = {(s_["labels"]["lane"], s_["labels"]["outcome"]): s_["value"]
                  for s_ in registry.get("microrank_policy_events_total").samples()}
    finally:
        os.environ["MICRORANK_POLICY_DIR"] = str(empty_policy_dir)
        set_registry(MetricsRegistry())
    explicit = run_rca_native(
        normal, abnormal, MicroRankConfig(spectrum=SpectrumConfig(method="ochiai")),
        device="cuda",
    )
    ranked = [r for r in tuned if r.ranking]
    check(ranked, "policy: no window was ranked")
    check(events == {("table", "applied"): 1.0},
          f"policy: policy events {events}, want one 'applied'")
    same = [(r.start, r.ranking, r.rank_iterations) for r in tuned] == [
        (r.start, r.ranking, r.rank_iterations) for r in explicit
    ]
    check(same, "policy: the tuned run is not bitwise the explicit ochiai run")
    check(counts == expected_counts(ranked[0].kernel, len(ranked)),
          f"policy: launch counts {counts}")
    return counts, {
        "phase": "policy",
        "profile": key,
        "policy": {"method": "ochiai", "kernel": "auto", "pad_policy": "pow2q"},
        "policy_events": {f"{k[0]}/{k[1]}": v for k, v in events.items()},
        "ranked": len(ranked),
        "kernel": ranked[0].kernel,
        "top5": ranked[0].ranking[:5],
        "ranking_bitwise_vs_explicit_ochiai": True,
    }


def phase_follow(torch, spmv, pattern, tl, normal_table, table, timeline_csv, workdir):
    """``run_follow`` on the card over the replay's timeline CSV grown in
    three appends (a collector's: the first part written, the injected
    ``sleep`` appending the next byte range of the timeline file, and a
    no-op once all is written), ``idle_exit=1``: the follower's rankings
    are bitwise those of a sync ``TableRCA.run`` over the whole file (the
    replay's table: the same bytes) up to its last horizon. Polls,
    windows per poll and ms per poll (each poll re-parses the whole file,
    as the JAX package's follower does)."""
    import filecmp

    from microrank_tpu_torch.obs import MetricsRegistry, set_registry
    from microrank_tpu_torch.pipeline import TableRCA
    from microrank_tpu_torch.pipeline.follow import run_follow

    t_phase = time.perf_counter()
    source, offsets = timeline_csv
    n = len(tl.windows)
    # Three parts: one window, one more, the rest. Each poll re-parses the
    # whole file, so small first parts keep the phase's parse time down
    # (1 + 2 + 8 windows parsed at bench.py's 8).
    cuts = [1, min(2, n), n] if n >= 3 else [n]
    ends = [offsets[c - 1] for c in cuts]
    csv = workdir / "follow" / "stream.csv"
    csv.parent.mkdir()
    written = [0]

    def grow(end):
        with open(source, "rb") as src, open(csv, "ab") as dst:
            src.seek(written[0])
            left = end - written[0]
            while left:
                chunk = src.read(min(left, 64 << 20))
                dst.write(chunk)
                left -= len(chunk)
        written[0] = end

    grow(ends[0])
    pending = list(ends[1:])
    marks, append_ms = [0.0], []

    def sleep(_):  # the collector appends the next part between polls
        t0 = time.perf_counter()
        if pending:
            grow(pending.pop(0))
        append_ms.append(round((time.perf_counter() - t0) * 1e3, 3))
        marks.append(time.perf_counter())

    per_poll = []

    def on_results(batch):
        per_poll.append((time.perf_counter() - marks[-1], sum(1 for r in batch if r.ranking)))

    registry = MetricsRegistry()
    set_registry(registry)
    rca = TableRCA(replay_config(tl), device="cuda")
    rca.fit_baseline(normal_table)
    reset_counts(spmv, pattern)
    out = workdir / "follow" / "out"
    marks[0] = time.perf_counter()
    ranked = run_follow(rca, csv, out, poll_seconds=0.0, idle_exit=1,
                        on_results=on_results, sleep=sleep)
    counts = read_counts(spmv, pattern)
    polls = registry.get("microrank_follow_polls_total").value()
    set_registry(MetricsRegistry())
    check(filecmp.cmp(csv, source, shallow=False),
          "follow: the grown file is not the timeline file")
    followed = [json.loads(ln) for ln in (out / "windows.jsonl").read_text().splitlines()]

    sync = TableRCA(replay_config(tl, pipeline_depth=1, async_dispatch=False), device="cuda")
    sync.fit_baseline(normal_table)
    ref = sync.run(table, end_us=int(table.start_us.max()), complete_only=True)
    got = [(r["start"], r["ranking"]) for r in followed if r["ranking"]]
    want = [(r.start, [list(x) for x in r.ranking]) for r in ref if r.ranking]
    check(ranked == len(want) and got == want,
          "follow: the followed rankings are not bitwise the sync run's over the file")
    check(not pending and len(per_poll) == len(cuts),
          f"follow: {len(per_poll)} productive polls for {len(cuts)} appends")
    check(counts == expected_counts("kind", ranked), f"follow: launch counts {counts}")
    return counts, {
        "phase": "follow",
        "windows": n,
        "appends_windows": [cuts[0]] + [b - a for a, b in zip(cuts, cuts[1:])],
        "polls": polls,
        "windows_ranked": ranked,
        "windows_per_poll": [w for _, w in per_poll],
        "ms_per_poll": [round(t * 1e3, 3) for t, _ in per_poll],
        "append_ms": append_ms,
        "rankings_bitwise_vs_sync_run": True,
        "phase_s": round(time.perf_counter() - t_phase, 3),
    }


def _time_ms(torch, fn, reps):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def spmv_bound(n_rows, entries, n_x):
    """(bytes, bytes ms, operations ms) of one SpMV: indptr, the live
    entries' cols and vals, and x read once, y written once; 2 flops per
    entry."""
    nbytes = 4 * (n_rows + 1) + 8 * entries + 4 * n_x + 4 * n_rows
    return nbytes, nbytes / HBM_BYTES_PER_S * 1e3, 2 * entries / F32_FLOPS_PER_S * 1e3


def step_matrices(torch, graph, gen):
    """One power-iteration step's six matrices at a graph's shapes, as
    the main path stages them: (group, layouts, xs), with random x
    vectors in the group's slots (rv_n, sv_n, rv_a, sv_a)."""
    from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
    from microrank_tpu_torch.rank_backends.torch_cuda import device_subset, spmv_layouts

    dev = torch.device("cuda")
    dgraph = device_subset(graph_from_numpy(graph, dev), "pallas")
    layouts = [*spmv_layouts(dgraph.normal), *spmv_layouts(dgraph.abnormal)]
    v = dgraph.normal.cov_unique.shape[0]
    sizes = (dgraph.normal.kind.shape[0], v, dgraph.abnormal.kind.shape[0], v)
    xs = [torch.rand(n, generator=gen, device=dev) for n in sizes]
    return dgraph.spmv_group, layouts, xs


def first_design(torch, spmv, layouts, xs):
    """The first, warp-per-row kernel over the same matrices: one launch
    per matrix, outputs preallocated. Returns (launch-all fn, outputs)."""
    lib = spmv.load_library()
    ys = [torch.empty(lay.n_rows, device=x.device) for lay, x in zip(layouts, xs)]
    stream = torch.cuda.current_stream().cuda_stream
    dev = torch.cuda.current_device()

    def run():
        for lay, x, y in zip(layouts, xs, ys):
            rc = lib.mr_coo_spmv_rows(
                lay.indptr.data_ptr(), lay.cols.data_ptr(), lay.vals.data_ptr(),
                x.data_ptr(), y.data_ptr(), lay.n_rows, x.shape[0], dev, stream,
            )
            check(rc == 0, f"first-design launch failed: {lib.mr_cuda_error_string(rc)}")

    return run, ys


def csr_of(torch, lay, n_x):
    e_live = int(lay.indptr[-1])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "beta state"
        return torch.sparse_csr_tensor(
            lay.indptr, lay.cols[:e_live], lay.vals[:e_live],
            size=(lay.n_rows, n_x), check_invariants=True,
        )


def measure_group(torch, spmv, name, group, layouts, xs):
    """Check and time one group of matrices on the card. ``xs`` are the
    group's slots; matrix m reads ``xs[group.x_slots[m]]``."""
    mx = [xs[s] for s in group.x_slots]
    ys = spmv.coo_spmv_group(group, xs)
    torch.cuda.synchronize()
    cpu_group = spmv.SpmvGroup(*(t.cpu() if torch.is_tensor(t) else t for t in group))
    ref = spmv.coo_spmv_group_plain(cpu_group, [x.cpu() for x in xs])
    bitwise = all(torch.equal(y.cpu(), r) for y, r in zip(ys, ref))
    check(bitwise, f"{name}: K1 differs from its plain version on the CPU")
    first = torch.cat(ys)
    again = [torch.cat(spmv.coo_spmv_group(group, xs)) for _ in range(REPEATS)]
    torch.cuda.synchronize()
    repeatable = all(torch.equal(a, first) for a in again)
    check(repeatable, f"{name}: K1 is not bitwise repeatable over {REPEATS} launches")
    check(not bool(group.counters.any()), f"{name}: arrival counters left non-zero")
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        y_plain = torch.cat(spmv.coo_spmv_group_plain(group, xs))
    finally:
        torch.use_deterministic_algorithms(prev)
    diff = (first - y_plain).abs()
    abs_err = float(diff.max()) if diff.numel() else 0.0
    rel_err = float((diff / y_plain.abs().clamp_min(1e-30)).max()) if diff.numel() else 0.0
    check(rel_err <= KERNEL_RTOL, f"{name}: rel err {rel_err} > {KERNEL_RTOL}")

    old, old_ys = first_design(torch, spmv, layouts, mx)
    old()
    old_rel = float(((torch.cat(old_ys) - y_plain).abs() / y_plain.abs().clamp_min(1e-30)).max())
    check(old_rel <= KERNEL_RTOL, f"{name}: first design rel err {old_rel} > {KERNEL_RTOL}")
    csrs = [csr_of(torch, lay, int(x.shape[0])) for lay, x in zip(layouts, mx)]
    lib_out = torch.cat([torch.mv(c, x) for c, x in zip(csrs, mx)])
    lib_rel = float(((lib_out - y_plain).abs() / y_plain.abs().clamp_min(1e-30)).max())

    # CUDA events per call behind a device spin; the two designs in
    # turns: first, chunked, chunked, first.
    calls = {
        "kernel": lambda: spmv.coo_spmv_group(group, xs),
        "first_design": old,
        "plain": lambda: spmv.coo_spmv_group_plain(group, xs),
        "library": lambda: [torch.mv(c, x) for c, x in zip(csrs, mx)],
    }
    turns = [(k, spin_event_ms(torch, calls[k], 20))
             for k in ("first_design", "kernel", "kernel", "first_design")]
    ms = {k: _mean([t for kk, t in turns if kk == k]) for k in ("kernel", "first_design")}
    ms["library"] = spin_event_ms(torch, calls["library"], 20)
    ms["plain"] = spin_event_ms(torch, calls["plain"], 3)
    total_bytes, bytes_ms, ops_ms = 0, 0.0, 0.0
    for lay, x in zip(layouts, mx):
        b, b_ms, o_ms = spmv_bound(lay.n_rows, int(lay.indptr[-1]), int(x.shape[0]))
        total_bytes, bytes_ms, ops_ms = total_bytes + b, bytes_ms + b_ms, ops_ms + o_ms
    return {
        "name": name,
        "matrices": len(layouts),
        "n_rows": [lay.n_rows for lay in layouts],
        "entries": [int(lay.indptr[-1]) for lay in layouts],
        "max_row_len": [int((lay.indptr[1:] - lay.indptr[:-1]).max()) for lay in layouts],
        "work_items": int(group.items.shape[0]),
        "max_chunks": group.max_chunks,
        "ms": round(ms["kernel"], 6),
        "first_design_ms": round(ms["first_design"], 6),
        "plain_ms": round(ms["plain"], 6),
        "library_ms": round(ms["library"], 6),
        "turns_ms": [[k, round(t, 6)] for k, t in turns],
        "bound_ms": round(max(bytes_ms, ops_ms), 6),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": total_bytes,
        "max_abs_err": abs_err, "max_rel_err": rel_err,
        "first_design_max_rel_err": old_rel, "library_max_rel_diff": lib_rel,
        "bitwise_vs_cpu_plain": bitwise,
        "bitwise_repeatable_launches": REPEATS,
    }


def call_graph_terms(torch, graph, kernel, gen):
    """K1's call on the kind and packed paths at a graph's shapes, as
    the main path stages it: both partitions' call-graph terms (K3 for
    kind, K4's B_ss for packed) in one group, with random x vectors.
    Returns (group, layouts, xs)."""
    from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
    from microrank_tpu_torch.rank_backends.torch_cuda import device_subset, host_subset, ss_layout

    dev = torch.device("cuda")
    dgraph = device_subset(graph_from_numpy(host_subset(graph, kernel), dev), kernel)
    parts = (dgraph.normal, dgraph.abnormal)
    xs = [torch.rand(g.cov_unique.shape[0], generator=gen, device=dev) for g in parts]
    return dgraph.spmv_group, [ss_layout(g, kernel) for g in parts], xs


def lowered_budgets(graph):
    """Dense budgets that send the uncollapsed window past the default
    policy: 64 MiB keeps config 5's bitmaps (about 5.3 MB, within a
    quarter) but not its unpacked matrices (about 169 MB), so auto picks
    packed_blocked; 16 MiB puts the bitmaps past a quarter, so it picks
    pcsr. At other sizes (--spans, --ops) the same inequalities set the
    budgets from the window's shapes."""
    shapes = budget_inequalities(graph, 0)
    bits, unpacked = shapes["bitmap_bytes"], shapes["unpacked_bytes"]
    blocked, pcsr = 64 << 20, 16 << 20
    if not 4 * bits <= blocked < unpacked:
        blocked = 4 * bits
    if not 4 * bits > pcsr:
        pcsr = 2 * bits
    return {"packed_blocked": blocked, "pcsr": pcsr}


def spin_event_ms(torch, fn, reps, cycles=None):
    """Device time (ms) of one call of ``fn`` by CUDA events, each call
    queued behind a device-side spin of ``cycles`` (SPIN_CYCLES, ~2 ms)
    so that the host's issue time never shows between the events: the
    median over ``reps`` calls. ``fn`` must not wait on the device."""
    return spin_event_host_ms(torch, fn, reps, cycles)[0]


def spin_event_host_ms(torch, fn, reps, cycles=None, settle=False):
    """``spin_event_ms`` and, beside it, the host's time to issue one
    call (the host clock around ``fn`` while the device spins, so no
    wait on the device is in it): (event ms, host ms), medians over
    ``reps`` calls. ``settle``: drain the device after each call, so that
    calls of many launches never fill the launch queue (the host would
    then wait in ``fn`` for the device)."""
    fn()
    torch.cuda.synchronize()
    pairs, host = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles or SPIN_CYCLES)
        start.record()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        stop.record()
        pairs.append((start, stop))
        if settle:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return _median([a.elapsed_time(b) for a, b in pairs]), _median(host)


def timer_check(torch):
    """The two device timers on work of known size: a device-to-device
    copy of 1 GiB (2 GiB moved), timed in turns by torch.profiler (device
    time per call) and by CUDA events behind a spin, each with the
    bandwidth it implies (a time that implies more than the card's
    3.35 TB/s is the timer's error); then the events' floor."""
    src = torch.empty(1 << 28, dtype=torch.float32, device="cuda")
    dst = torch.empty_like(src)

    def copy():
        dst.copy_(src)

    out = []
    for k in ("profiler", "events", "events", "profiler"):
        t = device_ms(torch, copy, 5) if k == "profiler" else spin_event_ms(torch, copy, 5)
        moved = 2 * src.numel() * 4
        out.append({"timer": k, "ms": t,
                    "tb_per_s": None if t is None else round(moved / t / 1e9, 3)})
    del src, dst
    torch.cuda.empty_cache()
    # The events' floor: a one-float add, the least a timed call can read.
    one = torch.zeros(1, device="cuda")
    out.append({"timer": "events", "call": "one-float add",
                "ms": spin_event_ms(torch, lambda: one.add_(1.0), 20)})
    return out


def measure_pcsr(torch, spmv, name, dgraph, reps, pallas_group=None):
    """Check and time the pcsr kernel's step at a window's shapes
    (``dgraph`` staged for pcsr on the card): bitwise its plain version on
    the CPU, the earlier design (K1 over ``pcsr_layouts``' work list) and,
    where given, the pallas work list of the same window; bitwise over
    REPEATS launches; within KERNEL_RTOL of its plain version on the
    card. Then timed in turns (earlier design, kernel, six cuSPARSE CSR
    matvecs, the same again in reverse) by CUDA events per call behind a
    device-side spin (the kernel's own time), by CUDA events over
    ``reps`` back-to-back calls and by torch.profiler (all device time
    per call); and the step's two halves as launches of their own. The
    bound counts the slabs' live entries, not their padding."""
    from microrank_tpu_torch.rank_backends.torch_cuda import (
        STEP_X_SLOTS,
        pcsr_layouts,
        window_spmv_group,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    group = dgraph.spmv_group
    parts = (dgraph.normal, dgraph.abnormal)
    xs = [torch.rand(n, generator=gen, device=dev)
          for p in parts for n in (p.kind.shape[0], p.cov_unique.shape[0])]
    layouts = [lay for p in parts for lay in pcsr_layouts(p)]
    prior = window_spmv_group(dgraph, pcsr_layouts)
    mx = [xs[s] for s in STEP_X_SLOTS]

    first = torch.cat(spmv.pcsr_spmv_group(group, xs))
    vs_prior = torch.equal(first, torch.cat(spmv.coo_spmv_group(prior, xs)))
    check(vs_prior, f"{name}: differs from K1 over the pcsr work list")
    if pallas_group is not None:
        check(torch.equal(first, torch.cat(spmv.coo_spmv_group(pallas_group, xs))),
              f"{name}: differs from the pallas work list")
    torch.cuda.synchronize()
    cpu = spmv.PcsrGroup(
        spmv.SpmvGroup(*(t.cpu() if torch.is_tensor(t) else t for t in group.rows)),
        tuple(spmv.EllPart(*(t.cpu() if torch.is_tensor(t) else t for t in e)) for e in group.ell),
        group.order,
    )
    ref = torch.cat(spmv.pcsr_spmv_group_plain(cpu, [x.cpu() for x in xs]))
    check(torch.equal(first.cpu(), ref), f"{name}: differs from its plain version on the CPU")
    again = [torch.cat(spmv.pcsr_spmv_group(group, xs)) for _ in range(REPEATS)]
    torch.cuda.synchronize()
    check(all(torch.equal(a, first) for a in again),
          f"{name}: not bitwise repeatable over {REPEATS} launches")
    check(not bool(group.rows.counters.any()), f"{name}: arrival counters left non-zero")
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        y_plain = torch.cat(spmv.pcsr_spmv_group_plain(group, xs))
    finally:
        torch.use_deterministic_algorithms(prev)
    diff = (first - y_plain).abs()
    abs_err = float(diff.max())
    rel_err = float((diff / y_plain.abs().clamp_min(1e-30)).max())
    check(rel_err <= KERNEL_RTOL, f"{name}: rel err {rel_err} > {KERNEL_RTOL}")
    csrs = [csr_of(torch, lay, int(x.shape[0])) for lay, x in zip(layouts, mx)]
    lib_out = torch.cat([torch.mv(c, x) for c, x in zip(csrs, mx)])
    lib_rel = float(((lib_out - y_plain).abs() / y_plain.abs().clamp_min(1e-30)).max())

    calls = {
        "kernel": lambda: spmv.pcsr_spmv_group(group, xs),
        "prior": lambda: spmv.coo_spmv_group(prior, xs),
        "library": lambda: [torch.mv(c, x) for c, x in zip(csrs, mx)],
        "plain": lambda: spmv.pcsr_spmv_group_plain(group, xs),
    }
    # The step's two halves as launches of their own: K1 over the same
    # work items alone, and the slabs alone (with the call edges as their
    # only items): what one launch saves or costs against two.
    ell_only = spmv.PcsrGroup(
        spmv.spmv_group([layouts[1], layouts[4]], (1, 3), (mx[1].shape[0], mx[4].shape[0])),
        group.ell, (0, 1, 2, 3),
    )
    calls["items_alone"] = lambda: spmv.coo_spmv_group(group.rows, xs)
    calls["slabs_alone"] = lambda: spmv.pcsr_spmv_group(ell_only, xs)
    turns = []
    for k in ("prior", "kernel", "library", "library", "kernel", "prior"):
        turns.append({
            "call": k,
            "profiler_ms": device_ms(torch, calls[k], 20),
            "event_ms": spin_event_ms(torch, calls[k], 20),
            "back_to_back_event_ms": _time_ms(torch, calls[k], reps),
        })
    split = {}
    for k in ("items_alone", "slabs_alone", "slabs_alone", "items_alone"):
        split[k] = split.get(k, 0.0) + spin_event_ms(torch, calls[k], 20) / 2
    plain_ms = spin_event_ms(torch, calls["plain"], 3)

    def mean(k, key):
        got = [t[key] for t in turns if t["call"] == k and t[key] is not None]
        return round(sum(got) / len(got), 6) if got else None

    times = {k: {key: mean(k, key) for key in ("profiler_ms", "event_ms", "back_to_back_event_ms")}
             for k in ("kernel", "prior", "library")}

    def bound(pairs, ell_parts):
        total, b_ms, o_ms = 0, 0.0, 0.0
        for lay, x in pairs:
            b, bm, om = spmv_bound(lay.n_rows, int(lay.indptr[-1]), int(x.shape[0]))
            total, b_ms, o_ms = total + b, b_ms + bm, o_ms + om
        for e in ell_parts:
            n_rows, live = e.ops.shape[0], int((e.vals != 0).sum())
            b = 8 * live + 4 * xs[e.slot].shape[0] + 4 * n_rows
            total += b
            b_ms += b / HBM_BYTES_PER_S * 1e3
            o_ms += 2 * live / F32_FLOPS_PER_S * 1e3
        return total, b_ms, o_ms

    row_pairs = [(layouts[m], mx[m]) for m in (0, 1, 3, 4)]
    n_bytes, b_ms, o_ms = bound(row_pairs, group.ell)
    p_bytes, pb_ms, po_ms = bound(list(zip(layouts, mx)), ())
    # The kernel's own time: CUDA events around each call behind a device
    # spin (stable to a fraction of a percent across turns); the
    # profiler's sum of the same calls is kept beside it.
    return {
        "name": name,
        "ell_shapes": [list(e.ops.shape) for e in group.ell],
        "work_items": int(group.rows.items.shape[0]),
        "prior_work_items": int(prior.items.shape[0]),
        "entries": [int(lay.indptr[-1]) for lay in layouts],
        "ms": times["kernel"]["event_ms"],
        "timed_by": "cuda_events",
        "times_ms": times,
        "turns": turns,
        "split_event_ms": {k: round(split[k], 6) for k in ("items_alone", "slabs_alone")},
        "prior_ms": times["prior"]["event_ms"],
        "library_ms": times["library"]["event_ms"],
        "plain_ms": round(plain_ms, 6),
        "bound_ms": round(max(b_ms, o_ms), 6),
        "bound_by": "bytes" if b_ms >= o_ms else "operations",
        "bytes": n_bytes,
        "prior_bound_ms": round(max(pb_ms, po_ms), 6),
        "prior_bytes": p_bytes,
        "max_abs_err": abs_err, "max_rel_err": rel_err,
        "library_max_rel_diff": lib_rel,
        "bitwise_vs_cpu_plain": True,
        "bitwise_vs_prior_work_list": vs_prior,
        "bitwise_vs_pallas_work_list": pallas_group is not None,
        "bitwise_repeatable_launches": REPEATS,
    }


def phase_kernel(torch, spmv, graphs, reps):
    """K1 per matrix (groups of one) at the uncollapsed shapes, then per
    step: the pallas path's grouped launch at both shapes ("off",
    "auto"), the auto path's launch of the two call-graph terms
    ("auto_path/kind", "auto_path/packed_bf16"), and the pcsr kernel's
    step at the window past the lowered budget ("pcsr", ``measure_pcsr``,
    against the pallas work list of the same window too)."""
    from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
    from microrank_tpu_torch.rank_backends.torch_cuda import device_subset, host_subset

    gen = torch.Generator(device=torch.device("cuda")).manual_seed(0)
    names = [f"{part}/{m}" for part in ("normal", "abnormal") for m in ("p_sr", "p_ss", "p_rs")]
    group, layouts, xs = step_matrices(torch, graphs["pallas/off"], gen)
    per_matrix = []
    for name, lay, slot, n_x in zip(names, layouts, group.x_slots, group.n_x):
        single = spmv.spmv_group([lay], (0,), (n_x,))
        per_matrix.append(measure_group(torch, spmv, name, single, [lay], [xs[slot]]))
    per_step = {"off": measure_group(torch, spmv, "step/off", group, layouts, xs)}
    pc_graph = device_subset(
        graph_from_numpy(host_subset(graphs["auto/pcsr"], "pcsr"), torch.device("cuda")), "pcsr"
    )
    per_step["pcsr"] = measure_pcsr(torch, spmv, "step/pcsr", pc_graph, reps, group)
    group, layouts, xs = step_matrices(torch, graphs["pallas/auto"], gen)
    per_step["auto"] = measure_group(torch, spmv, "step/auto", group, layouts, xs)
    for kernel, run in (("kind", "auto/auto"), ("packed_bf16", "auto/off")):
        name = f"auto_path/{kernel}"
        group, layouts, xs = call_graph_terms(torch, graphs[run], kernel, gen)
        per_step[name] = measure_group(torch, spmv, name, group, layouts, xs)
    return per_matrix, per_step


def pattern_inputs(torch, graph, kernel, gen):
    """The pattern-pair group of a graph as the main path stages it
    (both partitions), with random rv / sv vectors."""
    from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
    from microrank_tpu_torch.rank_backends.torch_cuda import device_subset, host_subset

    dev = torch.device("cuda")
    dgraph = device_subset(graph_from_numpy(host_subset(graph, kernel), dev), kernel)
    group = dgraph.pattern_group
    rvs = [torch.rand(p.n_cols, generator=gen, device=dev) for p in group.parts]
    svs = [torch.rand(p.pattern.shape[0], generator=gen, device=dev) for p in group.parts]
    return group, rvs, svs


def on_cpu(torch, pattern, group):
    """The same group rebuilt on the CPU (with the plain version's dense
    matrices)."""
    return pattern.pattern_group(
        [p.pattern.cpu() for p in group.parts], [p.w_len.cpu() for p in group.parts],
        [p.w_cov.cpu() for p in group.parts],
        [None if p.w_out is None else p.w_out.cpu() for p in group.parts],
        [p.n_cols for p in group.parts], blocked=group.blocked,
    )


def with_equal_rows_and_columns(torch, pattern, group):
    """A copy of the group whose patterns have row V/2 equal to row 0
    and the last column equal to column 1. Returns (group, pairs of
    (row, row) and (col, col) that must give equal bits)."""
    import numpy as np

    pats, pairs = [], []
    for p in group.parts:
        m = pattern.unpack_bits(p.pattern, p.n_cols).cpu().numpy().astype(np.uint8)
        v, k = m.shape
        m[v // 2] = m[0]
        m[:, k - 1] = m[:, 1]
        pats.append(torch.from_numpy(np.packbits(m, axis=1)).to(p.pattern.device))
        pairs.append(((0, v // 2), (1, k - 1)))
    eq = pattern.pattern_group(
        pats, [p.w_len for p in group.parts], [p.w_cov for p in group.parts],
        [p.w_out for p in group.parts], [p.n_cols for p in group.parts],
        blocked=group.blocked,
    )
    return eq, pairs


def pattern_bound(group, nnz):
    """(bytes, bytes ms, operations ms) of one pair call: each pattern
    read once as the bitmap [V, ceil(K/8)] the kernel reads (the kind
    build's bitmap as it is), rv, w_len, sv, w_cov (and w_out) read once,
    y_fwd, y_bwd (and x_ss) written once; one add per set cell and
    direction, plus the operand products. (int8's scales add 16 bytes,
    counted in; their maxima re-read the four operands, which the bound
    counts once.)"""
    nbytes, ops = 0, 0
    for p, n in zip(group.parts, nnz):
        v, k = p.pattern.shape[-2], p.n_cols
        ss = 0 if p.w_out is None else v  # w_out read, x_ss written
        nbytes += v * -(-k // 8) + 4 * (2 * k + 2 * v + ss) + 4 * (v + k + ss)
        ops += 2 * n + k + v + ss
    return nbytes, nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS_PER_S * 1e3


def measure_pattern(torch, pattern, name, group, rvs, svs, precision, cpu_check=True):
    """Check and time one step of the pattern pair (both partitions) on
    the card: one launch, or for int8 the scale launch and then the pair.
    ``cpu_check``: also hold it bitwise to its plain version computed on
    the CPU and check equal rows and columns of a constructed pattern
    (skipped at the giant shapes, where the card-side plain version and
    the repeat checks stand)."""
    int8 = precision == "int8"

    def step(g=group):
        scales = pattern.quantize_scales(g, rvs, svs) if int8 else None
        return pattern.pattern_pair_group(g, rvs, svs, precision, scales), scales

    def flat(outs, scales):
        parts = [t for pair in outs for t in pair if t is not None]
        return torch.cat(parts + ([] if scales is None else [scales]))

    calls0 = pattern.pattern_pair_group.launches
    outs, scales = step()
    torch.cuda.synchronize()
    first = flat(outs, scales)
    bitwise = None
    if cpu_check:
        cpu_group = on_cpu(torch, pattern, group)
        c_rvs, c_svs = [r.cpu() for r in rvs], [s_.cpu() for s_ in svs]
        c_scales = pattern.quantize_scales_plain(cpu_group, c_rvs, c_svs) if int8 else None
        ref = pattern.pattern_pair_plain(cpu_group, c_rvs, c_svs, precision, c_scales)
        bitwise = torch.equal(first.cpu(), flat(ref, c_scales))
        check(bitwise, f"{name}: the pattern pair differs from its plain version on the CPU")
        if group.blocked:  # K8's fwd partials as its plain layout has them
            for p, want in zip(group.parts, pattern.blocked_partials_plain(cpu_group, c_rvs)):
                check(want is None
                      or torch.equal(p.part[: want.numel()].view(want.shape).cpu(), want),
                      f"{name}: K8's fwd partials differ from blocked_partials_plain")
    again = [flat(*step()) for _ in range(REPEATS)]
    torch.cuda.synchronize()
    check(all(torch.equal(a, first) for a in again),
          f"{name}: not bitwise repeatable over {REPEATS} launches")
    check(not any(bool(p.counters.any()) for p in group.parts),
          f"{name}: arrival counters left non-zero")
    check(not group.amax_scratch.any(), f"{name}: the scale launch left its scratch non-zero")
    if cpu_check:
        eq, pairs = with_equal_rows_and_columns(torch, pattern, group)
        eq_outs, _ = step(eq)
        torch.cuda.synchronize()
        for (y_fwd, y_bwd, _), ((r0, r1), (c0, c1)) in zip(eq_outs, pairs):
            check(bool(y_fwd[r0] == y_fwd[r1]) and bool(y_bwd[c0] == y_bwd[c1]),
                  f"{name}: equal rows or columns give different bits")

    def plain():
        s_ = pattern.quantize_scales_plain(group, rvs, svs) if int8 else None
        return pattern.pattern_pair_plain(group, rvs, svs, precision, s_), s_

    y_plain = flat(*plain())
    diff = (first - y_plain).abs()
    abs_err = float(diff.max()) if diff.numel() else 0.0
    rel_err = float((diff / y_plain.abs().clamp_min(1e-30)).max()) if diff.numel() else 0.0
    check(rel_err <= KERNEL_RTOL, f"{name}: rel err {rel_err} > {KERNEL_RTOL}")
    card_bitwise = bool(torch.equal(first, y_plain))
    if int8:  # integer sums: the plain version on the card gives the same bits
        check(card_bitwise, f"{name}: the int8 step differs from its plain version on the card")

    # The library form JAX computes (a yardstick the port never calls):
    # f32 / bf16, the loop-invariant cast matrix and a pair of matmuls per
    # partition; int8, one torch._int_mm per direction and partition over
    # the unpacked int8 pattern (its transpose for the bwd direction, so
    # that the pattern is the left operand) with the quantized operand
    # padded to 8 columns, or four f32 torch.matmul where _int_mm refuses
    # the shape.
    mats, operands, nnz = [], [], []
    for i, (p, rv, sv) in enumerate(zip(group.parts, rvs, svs)):
        m = pattern.unpack_bits(p.pattern, p.n_cols)
        nnz.append(int(m.sum()))
        a, b = rv * p.w_len, sv * p.w_cov
        if int8:
            mats.append(m)
            operands.append((pattern.quantize_with(a, scales[2 * i]),
                             pattern.quantize_with(b, scales[2 * i + 1])))
        else:
            dtype = torch.bfloat16 if precision == "bf16" else torch.float32
            mats.append(m.to(dtype))
            operands.append((a.to(dtype), b.to(dtype)))
    library_form = "matmul"
    if int8:
        def pad8(q):  # the quantized vector as column 0 of 8
            out = torch.zeros((q.shape[0], 8), dtype=torch.int8, device=q.device)
            out[:, 0] = q.to(torch.int8)
            return out

        i8 = [(m.to(torch.int8), m.t().contiguous().to(torch.int8)) for m in mats]
        pad8 = [(pad8(a), pad8(b)) for a, b in operands]
        f32 = [(m, m.t().contiguous()) for m in mats]
        f32_ops = [(a.float(), b.float()) for a, b in operands]

        def int_mm():
            return [(torch._int_mm(mf, a8)[:, 0], torch._int_mm(mt, b8)[:, 0])
                    for (mf, mt), (a8, b8) in zip(i8, pad8)]

        try:
            lib_int = int_mm()
            torch.cuda.synchronize()
            library = int_mm
            library_form = "torch._int_mm"
            lib_out = torch.cat([torch.cat([f.float() * scales[2 * i], b.float() * scales[2 * i + 1]])
                                 for i, (f, b) in enumerate(lib_int)])
        except RuntimeError as exc:
            library_form = f"torch.matmul f32 (torch._int_mm refused: {str(exc)[:160]})"

            def library():
                return [(mf @ a, mt @ b) for (mf, mt), (a, b) in zip(f32, f32_ops)]

            lib_out = torch.cat([torch.cat([f * scales[2 * i], b * scales[2 * i + 1]])
                                 for i, (f, b) in enumerate(library())])
    else:
        def library():
            return [(m @ a, b @ m) for m, (a, b) in zip(mats, operands)]

        lib_out = torch.cat([torch.cat([f.float(), b.float()]) for f, b in library()])
    ours = torch.cat([torch.cat([f, b]) for f, b, _ in outs])
    lib_rel = float(((lib_out - ours).abs() / ours.abs().clamp_min(1e-30)).max())

    calls = {"kernel": lambda: step(), "plain": plain, "library": library}
    # CUDA events per call behind a device spin, in turns.
    turns = [(k, spin_event_ms(torch, calls[k], 20))
             for k in ("library", "kernel", "kernel", "library")]
    ms = {k: _mean([t for kk, t in turns if kk == k]) for k in ("kernel", "library")}
    ms["plain"] = spin_event_ms(torch, plain, 3)
    nbytes, bytes_ms, ops_ms = pattern_bound(group, nnz)
    if int8:
        nbytes += 4 * len(scales)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    out = {
        "name": name,
        "precision": precision,
        "n_rows": [p.pattern.shape[0] for p in group.parts],
        "n_cols": [p.n_cols for p in group.parts],
        "tiles": [[-(-p.pattern.shape[0] // pattern.TILE_R), -(-p.n_cols // pattern.TILE_C)]
                  for p in group.parts],
        "bitmap_bytes_read": [p.pattern.numel() for p in group.parts],
        "set_cells": nnz,
        "launches_during_checks": pattern.pattern_pair_group.launches - calls0,
        "ms": round(ms["kernel"], 6),
        "plain_ms": round(ms["plain"], 6),
        "library_ms": round(ms["library"], 6),
        "library_form": library_form,
        "turns_ms": [[k, round(t, 6)] for k, t in turns],
        "bound_ms": round(max(bytes_ms, ops_ms), 6),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": nbytes,
        "max_abs_err": abs_err, "max_rel_err": rel_err,
        "library_max_rel_diff": lib_rel,
        "bitwise_vs_cpu_plain": bitwise,
        "bitwise_vs_card_plain": card_bitwise,
        "bitwise_repeatable_launches": REPEATS,
        "equal_rows_and_columns_bitwise": True if cpu_check else None,
    }
    if group.blocked:
        out.update(previous_design(torch, pattern, group, rvs, svs, first, nbytes))
    if int8:
        # The two launches of the step apart: the scales alone, and the
        # pair alone on fixed scales.
        out["scale_ms"] = round(spin_event_ms(
            torch, lambda: pattern.quantize_scales(group, rvs, svs), 20), 6)
        out["pair_ms"] = round(spin_event_ms(
            torch, lambda: pattern.pattern_pair_group(group, rvs, svs, "int8", scales), 20), 6)
        out["scale_plain_ms"] = round(spin_event_ms(
            torch, lambda: pattern.quantize_scales_plain(group, rvs, svs), 3), 6)
        plain_scales = pattern.quantize_scales_plain(group, rvs, svs)
        out["scale_max_abs_err"] = float((scales - plain_scales).abs().max())
        # The scale launch alone: each operand and its weight read once,
        # the scales written once.
        scale_bytes = sum(4 * 2 * (p.n_cols + p.pattern.shape[0]) for p in group.parts)
        scale_bytes += 4 * len(scales)
        out["scale_bytes"] = scale_bytes
        out["scale_bound_ms"] = round(scale_bytes / HBM_BYTES_PER_S * 1e3, 6)
        out["scales"] = [float(x) for x in scales]
    return out


def tile_twin(pattern, group):
    """The tile kernel's group (K8's previous design) over the bitmaps and
    weights of K8's ``group``."""
    return pattern.pattern_group(
        [p.pattern for p in group.parts], [p.w_len for p in group.parts],
        [p.w_cov for p in group.parts], [p.w_out for p in group.parts],
        [p.n_cols for p in group.parts],
    )


def flat_pair(torch, outs):
    return torch.cat([t for pair in outs for t in pair if t is not None])


def previous_design(torch, pattern, group, rvs, svs, first, nbytes):
    """K8's kernel against the tile kernel in f32 on the same inputs:
    bitwise each other, timed in turns by CUDA events behind a spin; and
    the design's floor: the bound's ``nbytes`` plus K8's fwd partials
    written once and read once (4 bytes per row and column tile, for
    partitions of more than one column tile)."""
    twin = tile_twin(pattern, group)
    calls = {
        "blocked": lambda: pattern.pattern_pair_group(group, rvs, svs),
        "previous": lambda: pattern.pattern_pair_group(twin, rvs, svs),
    }
    check(torch.equal(flat_pair(torch, calls["previous"]()), first),
          "K8's kernel differs from the tile kernel (f32) on the same inputs")
    turns = [(k, spin_event_ms(torch, calls[k], 20))
             for k in ("previous", "blocked", "blocked", "previous")]
    n_cts = [-(-p.n_cols // pattern.TILE_C) for p in group.parts]
    traffic = sum(2 * 4 * p.pattern.shape[0] * n for p, n in zip(group.parts, n_cts) if n > 1)
    floor = nbytes + traffic
    out = {
        "previous_design_ms": round(_mean([t for k, t in turns if k == "previous"]), 6),
        "design_turns_ms": [[k, round(t, 6)] for k, t in turns],
        "bitwise_vs_previous_design": True,
        "scratch_bytes": sum(4 * (p.part.numel() + p.counters.numel()) for p in group.parts),
        "previous_scratch_bytes": sum(4 * (p.part.numel() + p.counters.numel())
                                      for p in twin.parts),
        "scratch_traffic_bytes": traffic,
        "floor_bytes": floor,
        "floor_ms": round(floor / HBM_BYTES_PER_S * 1e3, 6),
    }
    del twin
    return out


def random_bitmap(torch, v, k, density, gen):
    """uint8[v, ceil(k / 8)], np.packbits order, each bit set with
    probability ``density`` (every bit at 1.0), made on the card from
    ``gen`` 256 rows at a time."""
    dev = gen.device
    n_bytes = -(-k // 8)
    if density >= 1.0:
        return torch.full((v, n_bytes), 255, dtype=torch.uint8, device=dev)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32, device=dev)
    out = torch.empty((v, n_bytes), dtype=torch.uint8, device=dev)
    for r0 in range(0, v, 256):
        n = min(256, v - r0)
        bits = torch.rand((n, n_bytes * 8), generator=gen, device=dev) < density
        byte = (bits.view(n, n_bytes, 8).to(torch.int32) * weights).sum(-1)
        out[r0: r0 + n] = byte.to(torch.uint8)
    return out


def blocked_density_sweep(torch, pattern, group, densities=(0.02, 0.5, 1.0), reps=5):
    """K8's kernel and the tile kernel at the shapes of ``group`` (the
    giant window's) over synthetic bitmaps of each density from a seeded
    torch.Generator: bitwise each other, each timed by CUDA events behind
    a spin. Ranks nothing."""
    gen = torch.Generator(device=torch.device("cuda")).manual_seed(4)
    rvs = [torch.rand(p.n_cols, generator=gen, device="cuda") for p in group.parts]
    svs = [torch.rand(p.pattern.shape[0], generator=gen, device="cuda") for p in group.parts]
    out = []
    for density in densities:
        g = pattern.pattern_group(
            [random_bitmap(torch, p.pattern.shape[0], p.n_cols, density, gen)
             for p in group.parts],
            [p.w_len for p in group.parts], [p.w_cov for p in group.parts],
            [p.w_out for p in group.parts], [p.n_cols for p in group.parts], blocked=True,
        )
        twin = tile_twin(pattern, g)
        new = flat_pair(torch, pattern.pattern_pair_group(g, rvs, svs))
        check(torch.equal(new, flat_pair(torch, pattern.pattern_pair_group(twin, rvs, svs))),
              f"density {density}: K8's kernel differs from the tile kernel")
        out.append({
            "density": density,
            "ms": round(spin_event_ms(torch, lambda: pattern.pattern_pair_group(g, rvs, svs),
                                      reps), 6),
            "previous_design_ms": round(spin_event_ms(
                torch, lambda: pattern.pattern_pair_group(twin, rvs, svs), reps), 6),
            "bitwise_vs_previous_design": True,
        })
        del g, twin
    return out


def pattern_sweep(torch, pattern):
    """Where K4's time goes: one-partition bitmaps of 30% density at
    shapes that isolate the two folds — the full normal partition
    (3072 x 7168: 24 x 14 tiles); few rows (64 x 7168: one row stripe of
    14 tiles, the fwd fold alone); few columns (3072 x 256: one column
    stripe of 24 tiles, the bwd fold alone); one tile (64 x 256, no
    fold). Device ms per call."""
    import numpy as np

    gen = torch.Generator(device=torch.device("cuda")).manual_seed(2)
    rng = np.random.default_rng(2)
    out = []
    for v, k in ((3072, 7168), (64, 7168), (3072, 256), (64, 256)):
        bits = torch.from_numpy(np.packbits(rng.random((v, k)) < 0.3, axis=1)).cuda()
        vec = lambda n: torch.rand(n, generator=gen, device="cuda")  # noqa: E731
        group = pattern.pattern_group([bits], [vec(k)], [vec(v)], [vec(v)], [k])
        rv, sv = vec(k), vec(v)
        ms = spin_event_ms(
            torch, lambda: pattern.pattern_pair_group(group, [rv], [sv], "bf16"), 20
        )
        out.append({"rows": v, "cols": k, "ms": round(ms, 6)})
    return out


def phase_pattern(torch, pattern, graphs):
    """K2 at the collapsed shapes (f32, bf16; int8 at the int8 run's
    window, the scale launch and the pair) and K4 at the uncollapsed ones
    (packed, packed_bf16), and K8's kernel there too (the packed_blocked
    run's window): one pair call per step for both partitions."""
    gen = torch.Generator(device=torch.device("cuda")).manual_seed(1)
    out = {}
    group, rvs, svs = pattern_inputs(torch, graphs["auto/auto"], "kind", gen)
    for precision in ("f32", "bf16"):
        name = f"kind_{precision}"
        out[name] = measure_pattern(torch, pattern, name, group, rvs, svs, precision)
    group, rvs, svs = pattern_inputs(torch, graphs["auto/int8"], "kind", gen)
    out["kind_int8"] = measure_pattern(torch, pattern, "kind_int8", group, rvs, svs, "int8")
    group, rvs, svs = pattern_inputs(torch, graphs["auto/off"], "packed", gen)
    for precision in ("f32", "bf16"):
        name = "packed_bf16" if precision == "bf16" else "packed"
        out[name] = measure_pattern(torch, pattern, name, group, rvs, svs, precision)
    group, rvs, svs = pattern_inputs(torch, graphs["auto/packed_blocked"], "packed_blocked", gen)
    out["packed_blocked"] = measure_pattern(torch, pattern, "packed_blocked", group, rvs, svs,
                                            "f32")
    return out


def bits(torch, t):
    """A tensor's bits, for bitwise comparison (NaN included)."""
    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 else t


def plain_step_check(torch, dgraph, cfg, kernel):
    """One window (its layouts staged) through the fused step kernel,
    through the plain step (``power_step_plain``) on the card and
    through the two-launch step kernel: the weights, carried
    vectors, score vectors, residual trace and n_iters of
    ``window_weights_full``, and the ranking of
    ``rank_window_traced_core``, must be bitwise equal. Returns what it
    compared."""
    import functools

    import numpy as np

    from microrank_tpu_torch.ops import step
    from microrank_tpu_torch.rank_backends import torch_cuda

    def run():
        weights = torch_cuda.window_weights_full(dgraph, cfg.pagerank, kernel)
        ranked = torch_cuda.fetch_rank_outputs(torch_cuda.rank_window_traced_core(
            dgraph, cfg.pagerank, cfg.spectrum, kernel))
        return weights, ranked

    got = run()
    wants = {}
    saved = torch_cuda.StepWindow
    # A stacked group (K18) has no two-launch step: that kernel takes one
    # window.
    stacked = dgraph.normal.kind.dim() == 2
    for mode in ("plain",) if stacked else ("plain", "two_launch"):
        torch_cuda.StepWindow = functools.partial(step.StepWindow, mode=mode)
        try:
            wants[mode] = run()
        finally:
            torch_cuda.StepWindow = saved
    torch.cuda.synchronize()
    names = ("n_weight", "a_weight", "rv_n", "rv_a", "residuals", "n_iters", "score_n",
             "score_a")
    for mode, want in wants.items():
        for name, a, b in zip(names, got[0], want[0]):
            check(torch.equal(bits(torch, a), bits(torch, b)),
                  f"{kernel}: {name} through the step kernel differs from the {mode} step's")
        for name, a, b in zip(("top_idx", "top_scores", "n_valid", "residuals", "n_iters"),
                              got[1], want[1]):
            check(np.asarray(a).tobytes() == np.asarray(b).tobytes(),
                  f"{kernel}: {name} of the ranking differs from the {mode} step's")
    check(not dgraph.step_scratch.any(), f"{kernel}: the step kernel left its scratch non-zero")
    residuals, n_iters = np.asarray(got[1][3]), np.asarray(got[1][4])
    final = [[float(x) for x in r[:, max(int(n) - 1, 0)]]
             for r, n in zip(residuals.reshape(-1, *residuals.shape[-2:]), n_iters.reshape(-1))]
    return {
        "bitwise_vs_plain_step": True,
        "bitwise_vs_two_launch_step": None if stacked else True,
        "compared": list(names) + ["top_idx", "top_scores", "n_valid"],
        "n_iters": n_iters.tolist(),
        "final_residual": final if stacked else final[0],
        "any_nan": bool(torch.isnan(got[0][0]).any() or torch.isnan(got[0][1]).any()),
    }


def random_step_inputs(torch, gen, sizes, dev, empty=()):
    """Per partition (V, T) = sizes[p]: the step's products (y_sr,
    y_ss, y_rs), its carry (sv, rv) and pref, uniform in [0, 1); a
    partition in ``empty`` all zeros (empty at its pad)."""
    products, carry, prefs = [], [], []
    for p, (v, t) in enumerate(sizes):
        vecs = [torch.rand(n, generator=gen, device=dev) for n in (v, v, t, t, v, t)]
        if p in empty:
            vecs = [torch.zeros_like(x) for x in vecs]
        products.append(tuple(vecs[:3]))
        prefs.append(vecs[3])
        carry.append((vecs[4], vecs[5]))
    return tuple(products), tuple(carry), prefs


def step_chain(torch, fn, plan, products, carry, n_steps, want_scales=False, max_blocks=None):
    """``n_steps`` steps on fixed products from ``carry``: through one
    window of the fused kernel (``fn`` None, as the main path runs it;
    its grid capped at ``max_blocks``) or a chain of ``fn`` calls
    (power_step, power_step_two_launch, power_step_plain): every carry
    and scale, the residuals, n_iters and the running flag, as the int32
    bits of one tensor."""
    from microrank_tpu_torch.ops import step

    dev = carry[0][0].device
    residuals = torch.zeros((2, n_steps), dtype=torch.float32, device=dev)
    n_iters = running = None
    if plan.tol is not None:
        n_iters = torch.zeros((), dtype=torch.int32, device=dev)
        running = torch.ones((), dtype=torch.bool, device=dev)
    win = None
    if fn is None:
        win = step.StepWindow(plan, carry, residuals, n_iters, running, max_blocks=max_blocks)
    out = []
    for i in range(n_steps):
        scales_i = want_scales and i + 1 < n_steps
        if win is None:
            carry, scales = fn(plan, products, carry, residuals, i, n_iters, running, scales_i)
        else:
            carry, scales = win.step(products, i, scales_i)
        # A window's buffers are written again two steps on: clones.
        out += [t.clone() for part in carry for t in part]
        out += [] if scales is None else [scales.clone()]
    out = [torch.cat(out + [residuals.reshape(-1)]).view(torch.int32)]
    if n_iters is not None:
        out += [n_iters.reshape(1), running.to(torch.int32).reshape(1)]
    return torch.cat(out)


def step_bound(sizes):
    """(bytes, bytes ms) of one step of both partitions: y_sr, y_ss, sv
    (V floats each), y_rs, pref, rv (T each) read once, sv', rv' written
    once; the scalars and the residual column are noise."""
    nbytes = sum(16 * (v + t) for v, t in sizes)
    return nbytes, nbytes / HBM_BYTES_PER_S * 1e3


def measure_step(torch, name, sizes, reps, scale_group=None):
    """Check and time one power-iteration step's tail (both partitions)
    at ``sizes`` ((V, T) per partition, the window's) on random
    products. Checks: one step of the fused kernel bitwise its plain
    version on the card and the two-launch kernel; chains of 25
    steps through one window (25 launches) and through the two-launch kernel
    bitwise the plain chain, with the default configuration, with a tol
    (running, then frozen), with the first partition empty, and without
    normalization; with ``scale_group`` (the int8 window's pattern
    group) the fused int8 scales of every step too. Timed by CUDA events
    behind a spin, a window's step call as the main path makes it, in
    turns with the two-launch kernel (old, new, new, old) and beside the plain
    version and the byte bound; the host's time to issue a window's
    step call; the window's grid, elements a thread and register
    slots."""
    from microrank_tpu_torch.config import PageRankConfig
    from microrank_tpu_torch.ops import step

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    cfg = PageRankConfig()
    products, carry, prefs = random_step_inputs(torch, gen, sizes, dev)

    def plan_of(prefs_, tol=None, normalize=True, group=None):
        return step.step_plan(prefs_, cfg.call_weight, cfg.damping, tol, normalize,
                              step.step_scratch(dev), group)

    plan = plan_of(prefs)
    flats = {}
    for label, fn in (("fused", step.power_step), ("two_launch", step.power_step_two_launch),
                      ("plain", step.power_step_plain)):
        res = torch.zeros((2, STEPS), dtype=torch.float32, device=dev)
        new, _ = fn(plan, products, carry, res, 0)
        flats[label] = torch.cat([t for part in new for t in part] + [res.reshape(-1)])
    torch.cuda.synchronize()
    for label in ("plain", "two_launch"):
        check(torch.equal(bits(torch, flats["fused"]), bits(torch, flats[label])),
              f"{name}: the fused step kernel differs from the {label} step")
    err = float((flats["fused"] - flats["plain"]).abs().max())
    # Chains of 25 steps on fixed products: every step after the first
    # gives the same vectors (residual 0), so a tol of half the first
    # residual runs one step and freezes the rest.
    tol = float(flats["plain"][-2 * STEPS:].view(2, STEPS)[:, 0].max()) / 2
    e_products, e_carry, e_prefs = random_step_inputs(torch, gen, sizes, dev, empty=(0,))
    chains = {
        "default": (plan, products, carry, False),
        "tol": (plan_of(prefs, tol), products, carry, False),
        "empty_partition": (plan_of(e_prefs, 1e-4), e_products, e_carry, False),
        "no_normalize": (plan_of(prefs, normalize=False), products, carry, False),
    }
    if scale_group is not None:
        chains["int8_scales"] = (plan_of(prefs, group=scale_group), products, carry, True)
    for label, (pl, pr, ca, scales) in chains.items():
        before = step.power_step.launches
        a = step_chain(torch, None, pl, pr, ca, STEPS, scales)
        check(step.power_step.launches - before == STEPS * STEP_LAUNCHES,
              f"{name}: {label}: not one fused launch a step")
        b = step_chain(torch, step.power_step_two_launch, pl, pr, ca, STEPS, scales)
        c = step_chain(torch, step.power_step_plain, pl, pr, ca, STEPS, scales)
        torch.cuda.synchronize()
        check(torch.equal(a, c), f"{name}: {label} chain of the fused kernel differs from plain")
        check(torch.equal(b, c),
              f"{name}: {label} chain of the two-launch kernel differs from plain")
        check(not pl.scratch.any(), f"{name}: {label}: the step kernel left its scratch non-zero")

    res = torch.zeros((2, STEPS), dtype=torch.float32, device=dev)
    wins = {mode: step.StepWindow(plan, carry, res, mode=mode)
            for mode in ("kernel", "two_launch", "plain")}
    calls = {
        "new": lambda: wins["kernel"].step(products, 0),
        "old": lambda: wins["two_launch"].step(products, 0),
        "plain": lambda: wins["plain"].step(products, 0),
    }
    turns = ("old", "new", "new", "old", "plain", "plain")
    times, in_turns = {}, []
    for k in turns:
        t, host = spin_event_host_ms(torch, calls[k], reps)
        times.setdefault(k, []).append((t, host))
        in_turns.append([k, t, host])
    win = wins["kernel"]
    kcfg = step.kernel_config(dev)
    out = {
        "shapes": [list(x) for x in sizes], "max_abs_err": err, "bitwise_vs_plain": True,
        "bitwise_vs_previous_design": True, "chains_bitwise_vs_plain": sorted(chains),
        "launches_per_step": STEP_LAUNCHES,
        "grid": win.grid, "blocks_per_sm": kcfg.blocks_per_sm, "sms": kcfg.sms,
        "max_blocks": kcfg.max_blocks, "register_slots": win.slots,
        "elements_per_thread": win.per_thread,
        "in_registers": win.per_thread <= win.slots,
        "turns": in_turns,  # [call, event ms, host issue ms], in order
        "ms": min(t for t, _ in times["new"]),
        "previous_design_ms": min(t for t, _ in times["old"]),
        "plain_ms": min(t for t, _ in times["plain"]),
        "host_issue_ms": min(h for _, h in times["new"]),
        "previous_design_host_issue_ms": min(h for _, h in times["old"]),
        "plain_host_issue_ms": min(h for _, h in times["plain"]),
    }
    nbytes, bytes_ms = step_bound(sizes)
    out.update(bound_bytes=nbytes, bound_ms=bytes_ms, bound_by="bytes",
               # No single PyTorch call computes the step (a combination,
               # two maxima, two divisions, the residual maxima).
               library_ms=None, bound_share=round(bytes_ms / out["ms"], 4))
    return out


def window_sizes(dgraph):
    return [(int(p.cov_unique.shape[0]), int(p.kind.shape[0]))
            for p in (dgraph.normal, dgraph.abnormal)]


def rank_issue_split(torch, dgraph, cfg, kernel, reps=5):
    """The host's time to issue one rank program as the lane issues a
    window (``rank_window_traced_core``, then ``pack_rank_outputs``),
    each program queued behind a ~100 ms device spin so that no wait on
    the device is in it, split in three:

    * the set-up before the loop: the preference and initial vectors,
      the step plan, K5's window (``k5_setup``) and int8's first scales
      (``quantize``);
    * the steps, by wrapper: the pattern pair, K1 and K9 (the products)
      and K5, and the loop's own Python between them (``loop_other``);
    * the epilogue: ``_partition_finish`` of both partitions, the
      spectrum and top-k (``_finish_topk``), and the pack with its copy.

    Each wrapper is timed by the host clock around its call, by timers
    put in place of the names ``rank_backends.torch_cuda`` calls; ms,
    medians over ``reps`` programs, with the calls counted. The same
    program uninstrumented is timed in turns (``total_uninstrumented``):
    the difference is the timers' own cost."""
    from microrank_tpu_torch.rank_backends import torch_cuda as tc

    events = []

    def timed(name, fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            events.append((name, t0, time.perf_counter()))
            return out
        return call

    names = {"pattern_pair_group": "pattern_pair", "coo_spmv_group": "k1",
             "pcsr_spmv_group": "k9", "quantize_scales": "quantize",
             "_partition_finish": "finish", "_finish_topk": "spectrum_topk"}
    saved = {attr: getattr(tc, attr) for attr in [*names, "StepWindow"]}

    def timed_window(*args, **kw):
        t0 = time.perf_counter()
        win = saved["StepWindow"](*args, **kw)
        events.append(("k5_setup", t0, time.perf_counter()))
        win.step = timed("k5", win.step)
        return win

    def program():
        events.clear()
        torch.cuda._sleep(PROGRAM_SPIN_CYCLES)
        t0 = time.perf_counter()
        outs = tc.rank_window_traced_core(dgraph, cfg.pagerank, cfg.spectrum, kernel)
        t1 = time.perf_counter()
        tc.pack_rank_outputs(outs)
        t2 = time.perf_counter()
        torch.cuda.synchronize()
        return t0, t1, t2, list(events)

    def instrument(on):
        for attr, label in names.items():
            setattr(tc, attr, timed(label, saved[attr]) if on else saved[attr])
        tc.StepWindow = timed_window if on else saved["StepWindow"]

    rows, plain = [], []
    try:
        for turn in range(2 * reps + 2):  # warm pair first; instrumented, then not
            instrument(turn % 2 == 0)
            t0, t1, t2, ev = program()
            if turn < 2:
                continue
            if turn % 2:
                plain.append((t2 - t0) * 1e3)
                continue
            loop_ev = [e for e in ev if e[0] in ("pattern_pair", "k1", "k9", "k5")]
            first = min(e[1] for e in loop_ev)
            last = max(e[2] for e in ev if e[0] == "k5")

            def dur(label, lo=-1e300, hi=1e300):
                return sum(b - a for n, a, b in ev if n == label and a >= lo and b <= hi) * 1e3

            row = {"total": (t2 - t0) * 1e3, "setup": (first - t0) * 1e3,
                   "setup_k5_window": dur("k5_setup"), "setup_quantize": dur("quantize", hi=first),
                   "loop": (last - first) * 1e3,
                   **{f"loop_{n}": dur(n, lo=first, hi=last)
                      for n in ("pattern_pair", "k1", "k9", "k5")},
                   "epilogue": (t2 - last) * 1e3, "epilogue_finish": dur("finish"),
                   "epilogue_spectrum_topk": dur("spectrum_topk"), "epilogue_pack": (t2 - t1) * 1e3}
            row["setup_other"] = row["setup"] - row["setup_k5_window"] - row["setup_quantize"]
            row["loop_other"] = row["loop"] - sum(row[f"loop_{n}"]
                                                  for n in ("pattern_pair", "k1", "k9", "k5"))
            row["epilogue_other"] = row["epilogue"] - row["epilogue_finish"] - row[
                "epilogue_spectrum_topk"] - row["epilogue_pack"]
            row["calls"] = {n: sum(1 for e in ev if e[0] == n)
                            for n in ("pattern_pair", "k1", "k9", "k5", "quantize", "finish",
                                      "spectrum_topk")}
            rows.append(row)
    finally:
        instrument(False)
    out = {k: round(_median([r[k] for r in rows]), 4) for k in rows[0] if k != "calls"}
    out["calls"] = rows[0]["calls"]
    out["total_uninstrumented"] = round(_median(plain), 4)
    out["reps"] = reps
    out["shares"] = {k: round(out[k] / out["total"], 4) for k in ("setup", "loop", "epilogue")}
    return out


def phase_step(torch, graphs, reps):
    """K5 at the config-5 shapes: the kind window's step measured
    (``measure_step``), the int8 window's with its fused scales; the kind
    window through the plain step with a tol that stops it early; and a
    window with an empty normal partition (the giant tier's generator
    at 262,144 spans, its normal codes dropped) through both, bitwise;
    the kind rank program's issue split (``rank_issue_split``)."""
    import numpy as np

    from microrank_tpu_torch.config import MicroRankConfig, PageRankConfig
    from microrank_tpu_torch.graph.table_ops import build_window_graph_from_table
    from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
    from microrank_tpu_torch.rank_backends.torch_cuda import (
        device_subset,
        host_subset,
        window_weights_full,
    )
    from microrank_tpu_torch.testing import giant_window

    dev = torch.device("cuda")
    out = {"phase": "step"}
    kind = device_subset(graph_from_numpy(host_subset(graphs["auto/auto"], "kind"), dev), "kind")
    out["kind"] = measure_step(torch, "step/kind", window_sizes(kind), reps)
    int8 = device_subset(graph_from_numpy(host_subset(graphs["auto/int8"], "kind"), dev), "kind")
    out["kind_int8"] = measure_step(torch, "step/kind_int8", window_sizes(int8), reps,
                                    int8.pattern_group)
    # Where the kind rank program's issue goes.
    out["kind_issue_split_ms"] = rank_issue_split(torch, kind, MicroRankConfig(), "kind")
    # tol: the window's joint residual at step 10 as the tolerance.
    residuals = window_weights_full(kind, PageRankConfig(), "kind")[4]
    tol = float(residuals.max(0).values[9])
    cfg = MicroRankConfig(pagerank=PageRankConfig(tol=tol))
    out["kind_tol"] = {"tol": tol, **plain_step_check(torch, kind, cfg, "kind")}
    check(0 < out["kind_tol"]["n_iters"] < STEPS,
          f"step: the tol run did not stop early ({out['kind_tol']['n_iters']})")
    gw = giant_window(262_144, GIANT_OPS)
    graph, _, _, _ = build_window_graph_from_table(
        gw.table, None, np.zeros(0, np.int64), gw.abnormal_codes, aux="packed"
    )
    empty = device_subset(graph_from_numpy(host_subset(graph, "packed"), dev), "packed")
    for key, pr in (("empty_partition", PageRankConfig()),
                    ("empty_partition_tol", PageRankConfig(tol=1e-4))):
        out[key] = plain_step_check(torch, empty, MicroRankConfig(pagerank=pr), "packed")
        check(out[key]["any_nan"], f"step: {key}: the empty partition gave no NaN")
    check(out["empty_partition_tol"]["n_iters"] == 1,
          "step: an empty partition's NaN residual did not stop the tol run")
    return out


def step_split(torch, spmv, pattern, dg, kernel, reps=20):
    """One power-iteration step of a staged graph (a window, or a stacked
    group) split by kernel, on random inputs of its shapes: the route's
    products (the pcsr step; or the pair, K8 and its fold here, then K1's
    call-graph terms) and K5's step (``step_grid<S>`` for a window,
    ``step_grid_group`` for a group), each by CUDA events behind a
    device spin, the median of ``reps`` calls."""
    from microrank_tpu_torch.ops import step as step_mod

    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    dev = torch.device("cuda")
    lead = tuple(dg.normal.kind.shape[:-1])
    parts = (dg.normal, dg.abnormal)
    svs = [torch.rand(lead + (p.cov_unique.shape[-1],), generator=gen, device=dev) for p in parts]
    rvs = [torch.rand(lead + (p.kind.shape[-1],), generator=gen, device=dev) for p in parts]

    def products():
        if kernel == "pcsr":
            return spmv.pcsr_spmv_group(dg.spmv_group, (rvs[0], svs[0], rvs[1], svs[1]))
        outs = pattern.pattern_pair_group(dg.pattern_group, rvs, svs)
        xs = [sv if x is None else x for sv, (_, _, x) in zip(svs, outs)]
        return outs, spmv.coo_spmv_group(dg.spmv_group, xs)

    ys = tuple((torch.rand_like(sv), torch.rand_like(sv), torch.rand_like(rv))
               for sv, rv in zip(svs, rvs))
    plan = step_mod.step_plan([torch.rand_like(rv) for rv in rvs], 0.01, 0.85, None, True,
                              step_mod.step_scratch(dev, lead[0] if lead else 1))
    win = step_mod.StepWindow(plan, tuple(zip(svs, rvs)), torch.zeros(lead + (2, 1), device=dev))
    return {
        "products_ms": round(spin_event_ms(torch, products, reps), 6),
        "step_ms": round(spin_event_ms(torch, lambda: win.step(ys, 0), reps), 6),
        "step_kernel": "step_grid_group" if lead else f"step_grid<{win.slots}>",
        "step_grid": win.grid,
    }


def giant_stacked(torch, spmv, pattern, graph, single, kernel, cfg):
    """A giant window stacked twice (``stack_window_graphs``) and ranked
    as one program (K18): the host's stacking time, the group's staging
    (H2D and layouts), its launches (25 of each kernel for the group),
    each window's n_valid, n_iters and ranking against the window's own
    program (rtol 1e-5, bitwise reported), the group through the plain
    step on the card bitwise, the program timed in turns with the two
    windows' own programs (windows, stacked, stacked, windows; CUDA
    events and the host clock behind a spin), its window-axis kernels
    bitwise the window's own launches over 50 launches, and the peak
    device memory while the group is staged and ranked (the window's own
    staged graph resident beside it); a step of the group and of the
    window split by kernel (``step_split``). Returns (counts, info)."""
    from microrank_tpu_torch.parallel import stack_window_graphs
    from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
    from microrank_tpu_torch.rank_backends.torch_cuda import (
        device_subset,
        divide_block_budget,
        host_subset,
    )

    tag = f"giant_stacked/{kernel}"
    one = host_subset(graph, kernel)
    t0 = time.perf_counter()
    stack = stack_window_graphs([one, one])
    stack_ms = (time.perf_counter() - t0) * 1e3
    gcfg = cfg.replace(pagerank=divide_block_budget(cfg.pagerank, kernel, 2))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    card = device_subset(graph_from_numpy(stack, torch.device("cuda")), kernel,
                         gcfg.pagerank.packed_block_bytes)
    torch.cuda.synchronize()
    staging_ms = (time.perf_counter() - t0) * 1e3
    info, counts = stacked_program(torch, spmv, pattern, tag, card, [single, single], kernel, gcfg)
    peak = torch.cuda.max_memory_allocated()
    info.update(stacked_kernel_checks(torch, spmv, pattern, tag, card, None, [single, single]))
    info.update({
        "step_split": {"stacked": step_split(torch, spmv, pattern, card, kernel),
                       "window": step_split(torch, spmv, pattern, single, kernel)},
        "stack_host_ms": round(stack_ms, 3),
        "stack_host_bytes": int(sum(a.nbytes for part in (stack.normal, stack.abnormal)
                                    for a in part)),
        "staging_ms": round(staging_ms, 3),
        "resident_before_bytes": resident,
        "peak_device_memory_bytes": peak,
    })
    del card
    torch.cuda.empty_cache()
    return counts, info


def phase_giant(torch, spmv, pattern, n_spans, budget, want, reps):
    """One giant window (bench.py's giant tier, ``testing.giant_window``)
    through the lane's own seams, prepare_rank -> launch_rank ->
    finalize_rank, with its partition given: auto must resolve to
    ``want``. Checked tie-aware (top-5) against the float64 sparse
    oracle on the host graph; the stages timed as in window_breakdown;
    one step of the kernel checked against its plain version on the card
    and timed; then the window stacked twice as one program
    (``giant_stacked``). Collapse is off: the oracle ranks uncollapsed
    windows, and bench.py builds its giant window so. Returns (counts,
    kernel measurement, info, the stacked group's counts)."""
    from microrank_tpu_torch.config import MicroRankConfig, RuntimeConfig
    from microrank_tpu_torch.pipeline import TableRCA
    from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
    from microrank_tpu_torch.rank_backends.sparse_oracle import rank_window_sparse
    from microrank_tpu_torch.rank_backends.torch_cuda import (
        device_subset,
        fetch_rank_outputs,
        host_subset,
        rank_window_traced_core,
    )
    from microrank_tpu_torch.testing import giant_window
    from microrank_tpu_torch.utils.ranking_compare import tie_aware_topk_agreement

    tag = f"giant window of {n_spans} spans"
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    gw = giant_window(n_spans, GIANT_OPS)
    gen_s = time.perf_counter() - t0
    cfg = MicroRankConfig(runtime=RuntimeConfig(collapse_kinds="off", dense_budget_bytes=budget))
    rca = TableRCA(cfg, device="cuda")
    ms = {}

    # The main path, counted.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(spmv, pattern)
    t0 = time.perf_counter()
    graph, names, kernel = rca.prepare_rank(gw.table, None, gw.normal_codes, gw.abnormal_codes)
    ms["build"] = round((time.perf_counter() - t0) * 1e3, 3)
    t0 = time.perf_counter()
    top, scores, conv = rca.finalize_rank(rca.launch_rank(graph, names, kernel))
    torch.cuda.synchronize()
    ms["launch_and_finalize_cold"] = round((time.perf_counter() - t0) * 1e3, 3)
    counts = read_counts(spmv, pattern)
    main_peak = torch.cuda.max_memory_allocated()
    shapes = budget_inequalities(graph, budget)
    check(kernel == want, f"{tag}: auto resolved to {kernel}, want {want} ({shapes})")
    expect = expected_counts(want, 1)
    check(counts == expect, f"{tag}: launch counts {counts}, want {expect}")

    # The float64 oracle on the host graph.
    t0 = time.perf_counter()
    o_top, o_scores = rank_window_sparse(graph, names, cfg.pagerank, cfg.spectrum)
    oracle_s = time.perf_counter() - t0
    ok, why = tie_aware_topk_agreement(top, scores, o_top, o_scores, k=5, rtol=ORACLE_RTOL)
    check(ok, f"{tag}: top-5 against the float64 oracle: {why}")
    o_score = dict(zip(o_top, o_scores))
    rel = max(abs(s - o_score[n]) / abs(o_score[n]) for n, s in zip(top, scores) if n in o_score)

    # The stages again, warm, the device drained between them.
    def stage(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[name] = round((time.perf_counter() - t) * 1e3, 3)
        return out

    dgraph = stage("h2d", lambda: graph_from_numpy(host_subset(graph, kernel), dev))
    dgraph = stage("layouts", lambda: device_subset(dgraph, kernel, cfg.pagerank.packed_block_bytes))

    def rank():
        return rank_window_traced_core(dgraph, cfg.pagerank, cfg.spectrum, kernel)

    outs = stage("rank_issue_and_run", rank)
    stage("fetch", lambda: fetch_rank_outputs(outs))
    rank_device = (device_ms(torch, rank, 3),
                   spin_event_host_ms(torch, rank, 3, PROGRAM_SPIN_CYCLES))
    # K5: the window through the plain step and the two-launch step kernel,
    # bitwise, and its step at this window's shapes; where the rank
    # program's issue goes.
    plain_step = plain_step_check(torch, dgraph, cfg, kernel)
    step_kern = measure_step(torch, f"giant/{kernel}/step", window_sizes(dgraph), reps)
    issue_split = rank_issue_split(torch, dgraph, cfg, kernel)

    # One step of the kernel against its plain version on the card.
    gen = torch.Generator(device=dev).manual_seed(3)
    if kernel == "pcsr":
        pallas = device_subset(graph_from_numpy(graph, dev), "pallas").spmv_group
        kern = measure_pcsr(torch, spmv, f"giant/{kernel}", dgraph, reps, pallas)
        del pallas
    else:
        group = dgraph.pattern_group
        rvs = [torch.rand(p.n_cols, generator=gen, device=dev) for p in group.parts]
        svs = [torch.rand(p.pattern.shape[0], generator=gen, device=dev) for p in group.parts]
        kern = measure_pattern(torch, pattern, f"giant/{kernel}", group, rvs, svs, "f32",
                               cpu_check=False)
        cells = sum(p.pattern.shape[0] * p.n_cols for p in group.parts)
        kern["density_sweep"] = [{
            "density": sum(kern["set_cells"]) / cells, "ms": kern["ms"],
            "previous_design_ms": kern["previous_design_ms"], "bitwise_vs_previous_design": True,
        }] + blocked_density_sweep(torch, pattern, group)
    info = {
        "phase": "giant",
        "spans": gw.table.n_spans,
        "operations": GIANT_OPS,
        "resolved_kernel": kernel,
        "dense_budget": shapes,
        "incidence_entries": [int(p.n_inc) for p in (graph.normal, graph.abnormal)],
        "call_edges": [int(p.n_ss) for p in (graph.normal, graph.abnormal)],
        "launches": counts,
        "top5": list(zip(top[:5], scores[:5])),
        "oracle_top5": list(zip(o_top[:5], o_scores[:5])),
        "top5_tie_aware_vs_oracle": True,
        "oracle_rtol": ORACLE_RTOL,
        "max_rel_score_diff_vs_oracle": rel,
        "rank_iterations": None if conv is None else conv["iterations"],
        "generate_s": round(gen_s, 3),
        "oracle_s": round(oracle_s, 3),
        "stage_ms": ms,
        **rank_device_fields(rank_device, ms["rank_issue_and_run"]),
        "peak_device_memory_bytes_main_path": main_peak,
        "peak_device_memory_bytes": torch.cuda.max_memory_allocated(),
        "plain_step": plain_step,
        "step": step_kern,
        "issue_split_ms": issue_split,
        "kernel": kern,
    }
    stacked_counts, info["stacked"] = giant_stacked(torch, spmv, pattern, graph, dgraph, kernel,
                                                    cfg)
    return counts, (kern, step_kern), info, stacked_counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spans", type=int, default=1_000_000)
    ap.add_argument("--ops", type=int, default=5000)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument(
        "--replay-windows", type=int, default=6,
        help="windows of the replay timeline (bench.py's config 5 has 8 of "
             "--spans spans each); 0 skips the replay phase",
    )
    ap.add_argument(
        "--giant-spans", type=int, default=GIANT_SPANS,
        help="spans of the larger giant window (the smaller holds a fifth; the "
             "dense budget scales with it from 2 GiB at the default); 0 skips "
             "the giant phase",
    )
    args = ap.parse_args(argv)

    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; nothing to run", file=sys.stderr)
        return 2
    if not (ROOT / "microrank_tpu_torch" / "__init__.py").is_file():
        print(
            f"chip_smoke: the port (microrank_tpu_torch/) is not beside {ROOT}",
            file=sys.stderr,
        )
        return 2
    sys.path.insert(0, str(ROOT))
    from microrank_tpu_torch import native
    from microrank_tpu_torch.ops import pattern, spmv

    phase = "env"
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=ROOT / "bench_data"
                                    if (ROOT / "bench_data").is_dir() else ROOT))
    # No tuned policy reaches a run but the policy phase's: an empty
    # policy directory of this run's own.
    empty_policy_dir = workdir / "no_policy"
    empty_policy_dir.mkdir()
    os.environ["MICRORANK_POLICY_DIR"] = str(empty_policy_dir)
    try:
        env = phase_env(torch, spmv, pattern, native)
        emit(env)
        phase = "data"
        case, normal, abnormal, data = phase_data(args, workdir)
        emit(data)
        phase = "run"
        launches, graphs, results = {}, {}, {}
        for kernel in ("pallas", "auto"):
            for collapse in ("auto", "off"):
                graph, counts, res, info = phase_run(
                    torch, spmv, pattern, case, normal, abnormal, collapse, kernel
                )
                launches[f"{kernel}/{collapse}"] = counts
                graphs[f"{kernel}/{collapse}"] = graph
                results[f"{kernel}/{collapse}"] = res
                emit(info)
        # Past the dense budget: the default auto, collapse off, at lowered
        # budgets.
        budgets = lowered_budgets(graphs["pallas/off"])
        for want in ("packed_blocked", "pcsr"):
            graph, counts, res, info = phase_run(
                torch, spmv, pattern, case, normal, abnormal, "off", "auto",
                budgets[want], want,
            )
            launches[f"auto/{want}"] = counts
            graphs[f"auto/{want}"] = graph
            if want == "pcsr":
                same = [(r.ranking, r.rank_iterations) for r in res] == [
                    (r.ranking, r.rank_iterations) for r in results["pallas/off"]
                ]
                check(same, "pcsr: ranking is not bitwise the pinned pallas run's")
                info["ranking_bitwise_vs_pallas"] = True
            emit(info)
        # kind_precision="int8": auto, collapse on, resolves to kind; one
        # scale launch and one int8 pair launch per step.
        phase = "int8"
        graph, counts, res, info = phase_run(
            torch, spmv, pattern, case, normal, abnormal, "on", "auto", precision="int8",
        )
        launches["auto/int8"] = counts
        graphs["auto/int8"] = graph
        info["phase"] = "int8"
        emit(info)
        phase = "policy"
        counts, info = phase_policy(torch, spmv, pattern, normal, abnormal, workdir,
                                    empty_policy_dir)
        launches["policy"] = counts
        emit(info)
        phase = "replay"
        batched = None
        if args.replay_windows:
            replay, replay_windows, replay_launches, info = phase_replay(
                torch, spmv, pattern, args, workdir
            )
            launches.update(replay_launches)
            emit(info)
            phase = "follow"
            counts, info = phase_follow(torch, spmv, pattern, *replay, workdir)
            launches["follow"] = counts
            emit(info)
            phase = "batched"
            batched_launches, batched = phase_batched(
                torch, spmv, pattern, replay, replay_windows, graphs
            )
            launches.update(batched_launches)
            emit(batched)
            del replay
        phase = "kernel"
        per_matrix, per_step = phase_kernel(torch, spmv, graphs, args.reps)
        emit({"phase": "kernel", "per_matrix": per_matrix, "per_step": per_step,
              "rtol": KERNEL_RTOL})
        phase = "pattern"
        pairs = phase_pattern(torch, pattern, graphs)
        emit({"phase": "pattern", "per_step": pairs, "rtol": KERNEL_RTOL,
              "packed_bf16_sweep": pattern_sweep(torch, pattern)})
        phase = "step"
        steps = phase_step(torch, graphs, args.reps)
        emit(steps)
        phase = "giant"
        giant, giant_steps, giant_stacked_err = {}, {}, {}
        if args.giant_spans:
            budget = DEFAULT_BUDGET * args.giant_spans // GIANT_SPANS
            for n_spans, want in ((args.giant_spans // 5, "packed_blocked"),
                                  (args.giant_spans, "pcsr")):
                counts, (kern, step_kern), info, stacked_counts = phase_giant(
                    torch, spmv, pattern, n_spans, budget, want, args.reps
                )
                launches[f"giant/{want}"] = counts
                launches[f"giant_stacked/{want}"] = stacked_counts
                giant_stacked_err[want] = info["stacked"]["max_abs_err"]
                giant[want] = kern
                giant_steps[want] = step_kern
                emit(info)
                torch.cuda.empty_cache()
    except Exception as exc:  # report the failing phase, then fail
        emit({"phase": phase, "ok": False, "error": f"{type(exc).__name__}: {exc}"})
        traceback.print_exc()
        return 1
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    step = per_step["off"]
    kind, packed, int8 = pairs["kind_f32"], pairs["packed_bf16"], pairs["kind_int8"]
    # The window-axis kernels' errors against their plain versions in
    # the stacked groups (0.0 where bitwise), by route.
    stacked_err = {} if batched is None else {
        "kind": max(v.get("max_abs_err", 0.0) for v in batched["kind"].values()),
        "kind_int8": max(v["max_abs_err"] for v in batched["kind_int8"].values()),
        **{k: batched[k]["max_abs_err"]
           for k in ("pallas", "packed_bf16", "packed_blocked", "pcsr")},
    }
    for want, err in giant_stacked_err.items():
        stacked_err[want] = max(err, stacked_err.get(want, 0.0))
    # The stacked groups' launches (K18: one launch of each kernel a step
    # for a group): the batched phase's, the giant groups', the replay's
    # stacked modes'.
    stacked_keys = ("batched/", "giant_stacked/", *(f"replay/{m}" for m in STACKED_MODES))
    int8_keys = ("auto/int8", "replay/chunked_int8", "batched/kind_int8/")

    def stacked_launches(name, prefix=stacked_keys):
        return sum(c[name] for k, c in launches.items() if k.startswith(prefix))
    # packed_blocked runs K8's kernel: at the giant window of a fifth of
    # --giant-spans, else at the config-5 packed_blocked run's shapes.
    blocked = giant.get("packed_blocked", pairs["packed_blocked"])
    pcsr = giant.get("pcsr", per_step["pcsr"])
    # K5 at the 10M-span giant window's shapes, else the config-5 kind
    # window's.
    power = giant_steps.get("pcsr", steps["kind"])
    # Times are CUDA events around one call behind a device spin (the
    # kernel's own time; torch.profiler's summed device time misreads
    # this card's launches, see timer_check), library_ms and plain_ms
    # the same.
    # Where the command's time went: seconds since the start at each
    # phase's line (a repeated phase is keyed with "+").
    emit({"phase_end_seconds": PHASE_SECONDS})
    emit({"kernels": [
        {
            "name": "coo_spmv",
            "route": "cuda",
            "source": "microrank_tpu_torch/csrc/coo_spmv.cu",
            "replaces": "microrank_tpu/ops/pallas_spmv.py:95",
            # Every run's K1 launches: the pinned pallas runs (six SpMVs
            # a launch), the auto runs and the replay (the two call-graph
            # terms).
            "launches": sum(c["k1_launches"] for c in launches.values()),
            # Of them, the stacked groups' (one launch a step for the group).
            "stacked_launches": stacked_launches("k1_launches"),
            "max_abs_err": max([r["max_abs_err"] for r in
                                [*per_matrix, *(v for k, v in per_step.items() if k != "pcsr")]]
                               + list(stacked_err.values())),
            # Times are one power-iteration step (one launch, six SpMVs:
            # p_sr, p_ss, p_rs of both partitions) at the uncollapsed
            # config-5 shapes; library_ms is six CSR matvecs.
            "ms": step["ms"],
            "plain_ms": step["plain_ms"],
            "bound_ms": step["bound_ms"],
            "bound_by": step["bound_by"],
            "library_ms": step["library_ms"],
        },
        {
            "name": "kind_pair",
            "route": "cuda",
            "source": "microrank_tpu_torch/csrc/pattern_pair.cu",
            "replaces": "microrank_tpu/rank_backends/jax_tpu.py:558",
            # The f32 kind runs' launches: the collapsed auto run, the
            # policy run, the replay's and the follower's.
            "launches": sum(c["pattern_launches"] for k, c in launches.items()
                            if k in ("auto/auto", "policy", "follow")
                            or k.startswith(("replay/", "batched/kind/"))
                            and not k.startswith(int8_keys)),
            "stacked_launches": stacked_launches(
                "pattern_launches",
                ("batched/kind/", *(f"replay/{m}" for m in STACKED_MODES if m != "chunked_int8"))),
            "max_abs_err": max([pairs[k]["max_abs_err"] for k in ("kind_f32", "kind_bf16")]
                               + [stacked_err.get("kind", 0.0)]),
            # One step (one launch, both partitions, both directions) at
            # the collapsed config-5 shapes, kind_precision f32; library_ms
            # is four torch.matmul calls over the cast matrices.
            "ms": kind["ms"],
            "plain_ms": kind["plain_ms"],
            "bound_ms": kind["bound_ms"],
            "bound_by": kind["bound_by"],
            "library_ms": kind["library_ms"],
        },
        {
            "name": "kind_pair_int8",
            "route": "cuda",
            "source": "microrank_tpu_torch/csrc/pattern_pair.cu",
            "replaces": "microrank_tpu/rank_backends/jax_tpu.py:544",
            "launches": stacked_launches("pattern_launches", int8_keys),
            "stacked_launches": stacked_launches("pattern_launches", int8_keys[1:]),
            "max_abs_err": max(int8["max_abs_err"], stacked_err.get("kind_int8", 0.0)),
            # One int8 step's pair launch (both partitions, both
            # directions) at the collapsed config-5 shapes of the int8 run,
            # on fixed scales, as a step now launches it (the step kernel
            # gives the scales); ms_with_scale_launch is the scale launch
            # and the pair together, as every step ran them before, and
            # plain_ms the plain version of both. library_ms is one
            # torch._int_mm per direction and partition
            # (int8["library_form"] says which).
            "ms": int8["pair_ms"],
            "ms_with_scale_launch": int8["ms"],
            "plain_ms": int8["plain_ms"],
            "bound_ms": int8["bound_ms"],
            "bound_by": int8["bound_by"],
            "library_ms": int8["library_ms"],
        },
        {
            "name": "quantize_amax",
            "route": "cuda",
            "source": "microrank_tpu_torch/csrc/pattern_pair.cu",
            "replaces": "microrank_tpu/rank_backends/jax_tpu.py:96",
            "launches": stacked_launches("quantize_launches", int8_keys),
            "stacked_launches": stacked_launches("quantize_launches", int8_keys[1:]),
            "max_abs_err": int8["scale_max_abs_err"],
            # One launch per int8 window now (the first step's scales;
            # the step kernel takes every later step's). The launch alone
            # (the four operands' maxima and scales); its bound reads the
            # four operands and their weights once. No single PyTorch call
            # computes the four scales: library_ms is null.
            "ms": int8["scale_ms"],
            "plain_ms": int8["scale_plain_ms"],
            "bound_ms": int8["scale_bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
        },
        {
            "name": "packed_pair",
            "route": "cuda",
            "source": "microrank_tpu_torch/csrc/pattern_pair.cu",
            "replaces": "microrank_tpu/rank_backends/jax_tpu.py:419",
            "launches": launches["auto/off"]["pattern_launches"]
            + stacked_launches("pattern_launches", "batched/packed_bf16/"),
            "stacked_launches": stacked_launches("pattern_launches", "batched/packed_bf16/"),
            "max_abs_err": max([pairs[k]["max_abs_err"] for k in ("packed", "packed_bf16")]
                               + [stacked_err.get("packed_bf16", 0.0)]),
            # One step at the uncollapsed config-5 shapes, packed_bf16
            # (what auto runs there).
            "ms": packed["ms"],
            "plain_ms": packed["plain_ms"],
            "bound_ms": packed["bound_ms"],
            "bound_by": packed["bound_by"],
            "library_ms": packed["library_ms"],
        },
        {
            "name": "packed_blocked_pair",
            "route": "cuda",
            "source": "microrank_tpu_torch/csrc/pattern_pair.cu",
            "replaces": "microrank_tpu/rank_backends/jax_tpu.py:605",
            "launches": sum(c["blocked_launches"] for c in launches.values()),
            "stacked_launches": stacked_launches("blocked_launches"),
            "max_abs_err": max(blocked["max_abs_err"], stacked_err.get("packed_blocked", 0.0)),
            # One step (one launch of K8's kernel, both partitions, both
            # directions, f32) at the giant window's shapes; library_ms is
            # four f32 torch.matmul calls over the unpacked matrices;
            # previous_design_ms the tile kernel (K4's) on the same
            # inputs in the same run.
            "ms": blocked["ms"],
            "previous_design_ms": blocked["previous_design_ms"],
            "plain_ms": blocked["plain_ms"],
            "bound_ms": blocked["bound_ms"],
            "bound_by": blocked["bound_by"],
            "library_ms": blocked["library_ms"],
        },
        {
            "name": "pcsr_group",
            "route": "cuda",
            "source": "microrank_tpu_torch/csrc/coo_spmv.cu",
            "replaces": "microrank_tpu/rank_backends/jax_tpu.py:715",
            "launches": sum(c["pcsr_launches"] for c in launches.values()),
            "stacked_launches": stacked_launches("pcsr_launches"),
            "max_abs_err": max(pcsr["max_abs_err"], stacked_err.get("pcsr", 0.0)),
            # One step (one launch, six SpMVs: K1's work items over the op
            # side and the call edges, the trace side from the ELL slabs)
            # at the giant window's shapes; library_ms is six CSR matvecs.
            "ms": pcsr["ms"],
            "plain_ms": pcsr["plain_ms"],
            "bound_ms": pcsr["bound_ms"],
            "bound_by": pcsr["bound_by"],
            "library_ms": pcsr["library_ms"],
        },
        {
            "name": "power_step",
            "route": "cuda",
            "source": "microrank_tpu_torch/csrc/power_step.cu",
            "replaces": "microrank_tpu/rank_backends/jax_tpu.py:859",
            # Every counted main path's step launches: one a step on every
            # route (the fused kernel, one cooperative launch), a stacked
            # group's one a step for all its windows.
            "launches": sum(c["step_launches"] for c in launches.values()),
            "stacked_launches": stacked_launches("step_launches"),
            "max_abs_err": max(m["max_abs_err"] for m in
                               [steps["kind"], steps["kind_int8"], *giant_steps.values()]),
            # One step (one launch, both partitions) at the 10M-span giant
            # window's shapes (_config5_kind: the collapsed config-5 kind
            # window's, _giant_2m: the 2M-span window's);
            # previous_design_ms the two-launch kernel on the same
            # inputs in the same run, in turns (old, new, new, old). The
            # bound reads the three products, pref and the carry once and
            # writes the new carry once. No single PyTorch call computes
            # the step (a damped combination, two maxima, two divisions and
            # the residual maxima): library_ms is null.
            "ms": power["ms"],
            "previous_design_ms": power["previous_design_ms"],
            "ms_config5_kind": steps["kind"]["ms"],
            "previous_design_ms_config5_kind": steps["kind"]["previous_design_ms"],
            **({} if "packed_blocked" not in giant_steps else {
                "ms_giant_2m": giant_steps["packed_blocked"]["ms"],
                "previous_design_ms_giant_2m": giant_steps["packed_blocked"]["previous_design_ms"],
            }),
            "plain_ms": power["plain_ms"],
            "plain_ms_config5_kind": steps["kind"]["plain_ms"],
            "bound_ms": power["bound_ms"],
            "bound_by": power["bound_by"],
            "library_ms": None,
        },
    ]})
    print(env["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
