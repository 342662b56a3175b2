#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # full size: 1M spans, 5k operations
    python3 chip_smoke.py --spans N  # a smaller window, same shape of run

It drives only the port (``microrank_tpu_torch``) and imports nothing of
JAX or of the JAX package. Phases, one JSON line each:

1. env     — the card, its power limit, the kernels built from the
             sources in this checkout (nvcc for ``csrc/coo_spmv.cu``,
             g++ for the native span loader / graph builder, both at
             once), and one tiny launch of K1 held against its plain
             version;
2. data    — one detection window at bench.py's config-5 scale
             (1,000,000 spans, 5,000 operations, 100 trace kinds,
             child_keep_prob 0.55, 60 s fault, seed 0) from the port's
             own generator;
3. run     — ``run_rca_native(..., device="cuda")`` with
             collapse_kinds "auto" (as users run it) and "off" (K1 sees
             every entry): top-1 is the injected fault, K1's launch count
             is 25 steps x 2 partitions x 3 SpMVs per ranked window, and
             the CUDA run agrees tie-aware (rtol 1e-5) with the same run
             on the CPU;
4. kernel  — K1 at the uncollapsed shapes of phase 3: bitwise repeatable
             across launches, within rtol 1e-6 of its plain version on
             the card, and timed with CUDA events beside the plain
             version, a torch.sparse_csr_tensor matvec (a yardstick the
             port never calls) and the byte bound at 3.35 TB/s.

Then the kernel table, the card's name and power limit, and as the last
line ``{"ok": true, "device": {...}}``. Any failed phase exits non-zero.
Without a CUDA device, or without the port beside this script, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
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
STEPS_X_SPMVS = 2 * 3  # partitions x SpMVs per power-iteration step


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class PhaseError(RuntimeError):
    pass


def check(cond, msg) -> None:
    if not cond:
        raise PhaseError(msg)


def power_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"


def phase_env(torch, spmv, native):
    # Build both libraries from the checkout's sources, in parallel.
    for lib in (spmv.LIB_PATH, native.LIB_PATH):
        lib.unlink(missing_ok=True)

    def timed(fn):
        t0 = time.perf_counter()
        report = fn()
        return time.perf_counter() - t0, report

    with ThreadPoolExecutor(2) as pool:
        f_cuda = pool.submit(timed, spmv.build_library)
        f_host = pool.submit(timed, native.build_library)
        cuda_s, ptxas = f_cuda.result()
        host_s, _ = f_host.result()
    spmv.load_library()

    # First launch: a tiny ragged matrix (empty rows, a 70-entry row,
    # padding) against the plain version, before anything big runs.
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    rows = torch.cat([torch.zeros(70, dtype=torch.int32),
                      torch.randint(0, 37, (300,), generator=g, dtype=torch.int32),
                      torch.zeros(30, dtype=torch.int32)])
    cols = torch.randint(0, 53, (400,), generator=g, dtype=torch.int32)
    cols[-30:] = 0
    vals = torch.rand(400, generator=g)
    vals[-30:] = 0.0
    x = torch.rand(53, generator=g)
    lay = spmv.row_layout(rows.to(dev), cols.to(dev), vals.to(dev), 37, 370)
    y = spmv.coo_spmv(lay, x.to(dev))
    torch.cuda.synchronize()
    y_cpu = spmv.coo_spmv_plain(spmv.row_layout(rows, cols, vals, 37, 370), x)
    tiny_bitwise = bool(torch.equal(y.cpu(), y_cpu))
    check(tiny_bitwise, "tiny K1 launch differs from its plain version")
    return {
        "phase": "env",
        "device": torch.cuda.get_device_name(0),
        "device_count": torch.cuda.device_count(),
        "nvidia_smi": power_line(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
        "build_s": {"nvcc_coo_spmv": round(cuda_s, 3), "gxx_native": round(host_s, 3)},
        "ptxas": [ln.strip() for ln in ptxas.splitlines() if "ptxas" in ln],
        "tiny_launch_bitwise_vs_plain": tiny_bitwise,
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
        }
    return out


def device_ms(torch, fn, reps):
    """Device time per call of ``fn`` (kernels and copies it issues),
    from torch.profiler's CUDA activity; None when the profiler records
    no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
    total_us = sum(
        getattr(e, "self_device_time_total", 0) for e in events
    )
    return total_us / reps / 1e3 if total_us > 0 else None


def window_breakdown(torch, cfg, normal, abnormal, start_iso):
    """One ranked window again, through the lane's own seams, one stage
    at a time with the device drained between stages: where a window's
    wall time goes, and how busy the device is while the rank program
    runs. Returns (host graph, stage ms, device ms of the rank stage)."""
    import numpy as np

    from microrank_tpu_torch.native import load_span_table
    from microrank_tpu_torch.pipeline import TableRCA
    from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
    from microrank_tpu_torch.rank_backends.torch_cuda import (
        device_subset,
        fetch_rank_outputs,
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
    dgraph = stage("h2d", lambda: graph_from_numpy(graph, rca.device))
    dgraph = stage("layouts", lambda: device_subset(dgraph, kernel))

    def rank():
        return rank_window_traced_core(dgraph, cfg.pagerank, cfg.spectrum, kernel)

    outs = stage("rank_issue_and_run", rank)
    stage("fetch", lambda: fetch_rank_outputs(outs))
    rank_device = device_ms(torch, rank, 3)
    return graph, ms, rank_device


def phase_run(torch, spmv, case, normal, abnormal, collapse):
    from microrank_tpu_torch.config import MicroRankConfig, RuntimeConfig
    from microrank_tpu_torch.pipeline import run_rca_native
    from microrank_tpu_torch.utils.ranking_compare import tie_aware_topk_agreement

    cfg = MicroRankConfig(runtime=RuntimeConfig(collapse_kinds=collapse))
    walls, launches, res_gpu = [], [], None
    for _ in ("cold", "warm"):
        torch.cuda.synchronize()
        spmv.coo_spmv.launches = 0
        t0 = time.perf_counter()
        res_gpu = run_rca_native(normal, abnormal, cfg, device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches.append(spmv.coo_spmv.launches)

    t0 = time.perf_counter()
    res_cpu = run_rca_native(normal, abnormal, cfg, device="cpu")
    cpu_s = time.perf_counter() - t0

    ranked = [r for r in res_gpu if r.ranking]
    check(ranked, f"collapse={collapse}: no window was ranked")
    for n in launches:
        check(
            n == 25 * STEPS_X_SPMVS * len(ranked),
            f"collapse={collapse}: K1 launched {n} times for "
            f"{len(ranked)} ranked windows (want {25 * STEPS_X_SPMVS} each)",
        )
    top1 = ranked[0].ranking[0][0]
    check(
        top1 == case.fault_pod_op,
        f"collapse={collapse}: top-1 {top1} is not the fault {case.fault_pod_op}",
    )
    check(len(res_cpu) == len(res_gpu), "CPU and CUDA runs saw different windows")
    for rg, rc in zip(res_gpu, res_cpu):
        check(
            (rg.start, rg.anomaly, rg.n_normal, rg.n_abnormal)
            == (rc.start, rc.anomaly, rc.n_normal, rc.n_abnormal),
            f"window {rg.start}: detection differs between CUDA and CPU runs",
        )
        ok, why = tie_aware_topk_agreement(
            [n for n, _ in rg.ranking], [s for _, s in rg.ranking],
            [n for n, _ in rc.ranking], [s for _, s in rc.ranking],
            k=len(rg.ranking), rtol=RUN_RTOL,
        )
        check(ok, f"window {rg.start}: CUDA vs CPU ranking: {why}")
        check(rg.rank_iterations == rc.rank_iterations, "n_iters differ")

    graph, stages, rank_device = window_breakdown(
        torch, cfg, normal, abnormal, ranked[0].start
    )
    rank_wall = stages["rank_issue_and_run"]
    return graph, sum(launches), {
        "phase": "run",
        "collapse_kinds": collapse,
        "windows": len(res_gpu),
        "ranked": len(ranked),
        "shapes": graph_shapes(graph),
        "top5": ranked[0].ranking[:5],
        "top1_is_fault": True,
        "k1_launches_per_run": launches,
        "k1_launches_per_ranked_window": launches[-1] // len(ranked),
        "cuda_vs_cpu_tie_aware": True,
        "rank_iterations": ranked[0].rank_iterations,
        "cuda_wall_s_per_window": {
            "cold": round(walls[0] / len(res_gpu), 4),
            "warm": round(walls[1] / len(res_gpu), 4),
        },
        "cuda_window_timings_ms": ranked[0].timings,
        "stage_ms": stages,
        "rank_device_ms": None if rank_device is None else round(rank_device, 4),
        "rank_device_busy_share": (
            None if rank_device is None else round(rank_device / rank_wall, 4)
        ),
        "cpu_wall_s": round(cpu_s, 4),
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


def phase_kernel(torch, spmv, graph, reps):
    from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
    from microrank_tpu_torch.rank_backends.torch_cuda import device_subset

    dev = torch.device("cuda")
    dgraph = device_subset(graph_from_numpy(graph, dev), "pallas")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes_ms=0.0, ops_ms=0.0)
    max_abs = max_rel = 0.0
    for part in ("normal", "abnormal"):
        p = getattr(dgraph, part)
        n_x = {"p_sr": p.kind.shape[0], "p_ss": p.cov_unique.shape[0],
               "p_rs": p.cov_unique.shape[0]}
        for name, lay in zip(("p_sr", "p_ss", "p_rs"), p.row_layouts):
            x = torch.rand(n_x[name], generator=gen, device=dev)
            y1 = spmv.coo_spmv(lay, x)
            y2 = spmv.coo_spmv(lay, x)
            torch.cuda.synchronize()
            repeatable = bool(torch.equal(y1, y2))
            check(repeatable, f"{part}/{name}: K1 is not bitwise repeatable")
            prev = torch.are_deterministic_algorithms_enabled()
            torch.use_deterministic_algorithms(True)
            try:
                y_plain = spmv.coo_spmv_plain(lay, x)
            finally:
                torch.use_deterministic_algorithms(prev)
            cpu_lay = spmv.RowLayout(*(t.cpu() if torch.is_tensor(t) else t for t in lay))
            bitwise_cpu = bool(torch.equal(y1.cpu(), spmv.coo_spmv_plain(cpu_lay, x.cpu())))
            diff = (y1 - y_plain).abs()
            abs_err = float(diff.max())
            rel_err = float((diff / y_plain.abs().clamp_min(1e-30)).max())
            check(rel_err <= KERNEL_RTOL, f"{part}/{name}: rel err {rel_err} > {KERNEL_RTOL}")
            max_abs, max_rel = max(max_abs, abs_err), max(max_rel, rel_err)

            n_rows = lay.n_rows
            e_live = int(lay.indptr[-1])
            row_len = lay.indptr[1:] - lay.indptr[:-1]
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)  # "beta state"
                csr = torch.sparse_csr_tensor(
                    lay.indptr, lay.cols[:e_live], lay.vals[:e_live],
                    size=(n_rows, int(x.shape[0])), check_invariants=True,
                )
            y_lib = torch.mv(csr, x)
            lib_rel = float(((y_lib - y_plain).abs() / y_plain.abs().clamp_min(1e-30)).max())
            # Device time per call (profiler) is the kernel's cost; the
            # CUDA-event time of back-to-back calls is bounded by how
            # fast the host can issue them, and is kept beside it.
            calls = {
                "kernel": lambda: spmv.coo_spmv(lay, x),
                "plain": lambda: spmv.coo_spmv_plain(lay, x),
                "library": lambda: torch.mv(csr, x),
            }
            dev_ms = {k: device_ms(torch, f, 20) for k, f in calls.items()}
            issue_ms = {k: _time_ms(torch, f, reps) for k, f in calls.items()}
            k_ms, p_ms, l_ms = (
                dev_ms[k] if dev_ms[k] is not None else issue_ms[k]
                for k in ("kernel", "plain", "library")
            )
            # Least bytes: indptr, cols and vals of the live entries and
            # x read once, y written once; 2 flops per entry.
            nbytes = 4 * (n_rows + 1) + 8 * e_live + 4 * int(x.shape[0]) + 4 * n_rows
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = 2 * e_live / F32_FLOPS_PER_S * 1e3
            rows.append({
                "matrix": f"{part}/{name}", "n_rows": n_rows, "n_x": int(x.shape[0]),
                "entries": e_live, "max_row_len": int(row_len.max()),
                "ms": round(k_ms, 5), "plain_ms": round(p_ms, 5),
                "library_ms": round(l_ms, 5),
                "timed_by": "profiler" if dev_ms["kernel"] is not None else "cuda_events",
                "issue_bound_ms": {k: round(v, 5) for k, v in issue_ms.items()},
                "bound_ms": round(max(bytes_ms, ops_ms), 6),
                "bytes": nbytes, "max_abs_err": abs_err, "max_rel_err": rel_err,
                "bitwise_repeatable": repeatable, "bitwise_vs_cpu_plain": bitwise_cpu,
                "library_max_rel_diff": lib_rel,
            })
            totals["ms"] += k_ms
            totals["plain_ms"] += p_ms
            totals["library_ms"] += l_ms
            totals["bytes_ms"] += bytes_ms
            totals["ops_ms"] += ops_ms
    totals["bound_ms"] = max(totals["bytes_ms"], totals["ops_ms"])
    return rows, totals, max_abs, max_rel


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spans", type=int, default=1_000_000)
    ap.add_argument("--ops", type=int, default=5000)
    ap.add_argument("--reps", type=int, default=200)
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
    from microrank_tpu_torch.ops import spmv

    phase = "env"
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=ROOT / "bench_data"
                                    if (ROOT / "bench_data").is_dir() else ROOT))
    try:
        env = phase_env(torch, spmv, native)
        emit(env)
        phase = "data"
        case, normal, abnormal, data = phase_data(args, workdir)
        emit(data)
        phase = "run"
        launches, graph_off = 0, None
        for collapse in ("auto", "off"):
            graph, n, info = phase_run(torch, spmv, case, normal, abnormal, collapse)
            launches += n
            emit(info)
            if collapse == "off":
                graph_off = graph
        phase = "kernel"
        rows, totals, max_abs, max_rel = phase_kernel(torch, spmv, graph_off, args.reps)
        emit({"phase": "kernel", "per_matrix": rows,
              "per_step": {k: round(v, 6) for k, v in totals.items()},
              "rtol": KERNEL_RTOL, "max_abs_err": max_abs, "max_rel_err": max_rel})
    except Exception as exc:  # report the failing phase, then fail
        emit({"phase": phase, "ok": False, "error": f"{type(exc).__name__}: {exc}"})
        traceback.print_exc()
        return 1
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    emit({"kernels": [{
        "name": "coo_spmv",
        "route": "cuda",
        "source": "microrank_tpu_torch/csrc/coo_spmv.cu",
        "replaces": "microrank_tpu/ops/pallas_spmv.py:95",
        "launches": launches,
        "max_abs_err": max_abs,
        # Times are one power-iteration step's six SpMVs (2 partitions
        # x p_sr, p_ss, p_rs) at the uncollapsed config-5 shapes.
        "ms": round(totals["ms"], 6),
        "plain_ms": round(totals["plain_ms"], 6),
        "bound_ms": round(totals["bound_ms"], 6),
        "bound_by": "bytes" if totals["bytes_ms"] >= totals["ops_ms"] else "operations",
        "library_ms": round(totals["library_ms"], 6),
    }]})
    print(env["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
