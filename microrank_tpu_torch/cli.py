"""Command line of the port (counterpart of the native branch of
``microrank_tpu/cli/main.py`` ``cmd_run``, ``cmd_stats``, plus
``synth``).

    python -m microrank_tpu_torch.cli run --normal N --abnormal A -o OUT [--device cuda|cpu]
        [--spectrum-method M] [--top-max K] [--iterations N] [--damping D]
        [--call-weight W] [--preference reference|paper] [--k-sigma S]
        [--slack-ms MS] [--slo-stat mean|pNN] [--detect-minutes M]
        [--skip-minutes M] [--reference-compat] [--slo-cache NPZ]
        [--kind-dedup-threshold F]
        [--kernel auto|kind|packed|packed_bf16|packed_blocked|pcsr|csr|coo|dense|dense_bf16|pallas]
        [--kind-precision f32|bf16|int8] [--pipeline-depth N] [--sync-dispatch]
        [--fetch-mode stream|bulk] [--bulk-fetch-windows N]
        [--dispatch-batch-windows N] [--no-blob-staging] [--device-checks] [--resume]
        [--no-tuned-policy]
        [--metrics-port N] [--quarantine-dir DIR] [--no-span-trace] [--span-ring N]
        [--follow [--poll-seconds S] [--follow-grace-seconds S] [--follow-idle-exit N]]
    python -m microrank_tpu_torch.cli stats OUT [OUT2] [--diff] [--merge]
        [--format prom|json] [--journal]
    python -m microrank_tpu_torch.cli synth -o DIR [--operations 40 ...]
    python -m microrank_tpu_torch.cli eval [--cases 20] [--operations 30] [--traces 400]
        [--pods 1] [--kinds 48] [--faults 1] [--fault-ms 2000] [--keep-prob 0.15]
        [--fault-overlap F] [--overlap-ablation] [--seed 1000] [--all-methods]
        [--detection [--windows 10]] [--json PATH] [--backend torch|numpy_ref]
        [--device cuda|cpu] [the config flags of run]

``run`` ranks every anomalous window of the abnormal dump and writes
``OUT/result.csv`` and ``OUT/windows.jsonl`` in the JAX package's
format, with the window cursor, the run journal, the metrics snapshot
(``metrics.json``, ``metrics.prom``) and the dead-letter store of
rejected rows (``quarantine.jsonl``, or in ``--quarantine-dir``) beside
them. It runs on
the card unless ``--device cpu`` is given. ``--follow`` tails a growing
abnormal dump and ranks windows as they close. ``stats`` re-emits a
finished run's snapshot, as the JAX package's ``cli stats`` does, and
reads either package's ``metrics.json``. ``eval`` is the accuracy
experiment (``evaluation``): R@k and Exam Score over synthetic chaos
cases, per formula with ``--all-methods``, window detection quality
with ``--detection``, two-fault accuracy against path overlap with
``--overlap-ablation``; its lines and ``--json`` keys are the JAX CLI's.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from pathlib import Path
from typing import List, Optional

from .config import (
    BACKENDS,
    FETCH_MODES,
    KERNELS,
    KIND_PRECISIONS,
    CompatConfig,
    DetectorConfig,
    IngestConfig,
    MicroRankConfig,
    ObsConfig,
    PageRankConfig,
    RuntimeConfig,
    SpectrumConfig,
    WindowConfig,
)

log = logging.getLogger("microrank_tpu_torch.cli")


def _positive_int(text: str) -> int:
    value = int(text)
    if value < 1:
        raise argparse.ArgumentTypeError(f"expected a positive integer, got {text}")
    return value


def _config_from_args(args) -> MicroRankConfig:
    # The ranking and detection flags carry the JAX CLI's defaults, so a
    # flag given explicitly differs from the built-in default and beats a
    # tuned policy (scenarios.policy); the loop's knobs override the
    # config only where given, as in the JAX CLI.
    loop = {
        k: v for k, v in (
            ("pipeline_depth", args.pipeline_depth),
            ("fetch_mode", args.fetch_mode),
            ("bulk_fetch_windows", args.bulk_fetch_windows),
            ("dispatch_batch_windows", args.dispatch_batch_windows),
            ("kind_dedup_threshold", args.kind_dedup_threshold),
        ) if v is not None
    }
    if args.sync_dispatch:
        loop["async_dispatch"] = False
    if args.no_blob_staging:
        loop["blob_staging"] = False
    if args.device_checks:
        loop["device_checks"] = True
    if args.no_tuned_policy:
        loop["tuned_policy"] = "off"
    precision = {} if args.kind_precision is None else {"kind_precision": args.kind_precision}
    # The tracer's and the dead-letter store's flags, as the JAX CLI's:
    # each overrides the config only when given.
    obs = {k: v for k, v in (("spans", False if args.no_span_trace else None),
                             ("span_ring", args.span_ring)) if v is not None}
    ingest = {} if args.quarantine_dir is None else {"quarantine_dir": args.quarantine_dir}
    cfg = MicroRankConfig(
        detector=DetectorConfig(
            k_sigma=args.k_sigma, slack_ms=args.slack_ms, slo_stat=args.slo_stat,
        ),
        pagerank=PageRankConfig(
            iterations=args.iterations, damping=args.damping,
            call_weight=args.call_weight, preference=args.preference, **precision,
        ),
        spectrum=SpectrumConfig(method=args.spectrum_method, top_max=args.top_max),
        window=WindowConfig(
            detect_minutes=args.detect_minutes, skip_minutes=args.skip_minutes,
        ),
        runtime=RuntimeConfig(
            kernel=args.kernel, collapse_kinds=args.collapse_kinds,
            device=args.device, backend=getattr(args, "backend", "torch"), **loop,
        ),
        ingest=IngestConfig(**ingest),
        obs=ObsConfig(**obs),
    )
    if args.reference_compat:
        cfg = cfg.replace(compat=CompatConfig(partition_swap=True, overwrite_results=True))
    return cfg


def _print_windows(results) -> None:
    """Each ranked window's ranking, in the JAX CLI's format."""
    for r in results:
        if r.ranking:
            print(f"window {r.start}:")
            for rank, (name, score) in enumerate(r.ranking, 1):
                print(f"  {rank:2d}. {name:<50s} {score:.8f}")


def cmd_run(args) -> int:
    from .native import load_span_table
    from .pipeline import TableRCA

    cfg = _config_from_args(args)
    server = None
    if args.metrics_port is not None:
        from .obs.server import start_metrics_server

        server = start_metrics_server(args.metrics_port)
        log.info(
            "metrics endpoint: http://127.0.0.1:%d/metrics (+ "
            "/metrics.json, /healthz)",
            server.port,
        )

    def _write_metrics(dest) -> None:
        """Persist the metrics snapshot next to the results so
        ``cli stats <out_dir>`` works after the process exits."""
        if dest is None or not cfg.runtime.telemetry:
            return
        from .obs import get_registry
        from .obs.metrics import ensure_catalog

        ensure_catalog()
        get_registry().write_snapshot(dest)

    if args.bulk_fetch_windows is not None and cfg.runtime.fetch_mode != "bulk":
        log.warning("--bulk-fetch-windows has no effect without --fetch-mode bulk")
    try:
        rca = TableRCA(cfg)
        rca.fit_baseline(load_span_table(args.normal), cache_path=args.slo_cache)
        out_dir = args.output or None
        if args.follow:
            # Online mode: tail the growing abnormal CSV, ranking windows
            # as they close (pipeline.follow). The window cursor in
            # out_dir makes polls and restarts incremental.
            if out_dir is None:
                log.error("--follow needs -o/--output (window cursor)")
                return 2
            from .pipeline.follow import run_follow

            n = run_follow(
                rca,
                args.abnormal,
                out_dir,
                poll_seconds=args.poll_seconds,
                grace_us=int(args.follow_grace_seconds * 1e6),
                idle_exit=args.follow_idle_exit or 0,
                on_results=_print_windows,
            )
            log.info("follow: %d windows ranked; results in %s", n, out_dir)
            _write_metrics(out_dir)
            return 0
        results = rca.run(
            load_span_table(args.abnormal), out_dir=out_dir, resume=args.resume
        )
        _write_metrics(out_dir)
        log.info(
            "processed %d windows, %d anomalous; results in %s",
            len(results), sum(r.anomaly for r in results), args.output,
        )
        _print_windows(results)
        return 0
    finally:
        if server is not None:
            server.close()


def _load_snapshot(target: Path):
    """Resolve a stats target (run dir or metrics.json path) to its
    parsed snapshot dict, or None with a message on stderr."""
    snap_path = target / "metrics.json" if target.is_dir() else target
    if not snap_path.exists():
        print(
            f"no metrics snapshot at {snap_path} (run `cli run -o "
            f"{target}` first, or point at a metrics.json)",
            file=sys.stderr,
        )
        return None
    return json.loads(snap_path.read_text())


def _merge_targets(paths):
    """Resolve ``--merge`` targets to one federated registry. Each target
    is a run dir / metrics.json path, or a directory with
    ``host*/metrics.json`` children, which expands to those per-host
    snapshots (its own top-level metrics.json is already their merged
    view). The host label on gauges is the snapshot's directory name.
    Returns None (with a stderr message) on a missing target."""
    from .obs import merge_registries, registry_from_json

    sources = []
    for t in paths:
        tp = Path(t)
        children = (
            sorted(tp.glob("host*/metrics.json")) if tp.is_dir() else []
        )
        for p in children or [tp]:
            data = _load_snapshot(Path(p))
            if data is None:
                return None
            p = Path(p)
            label = (p if p.is_dir() else p.parent).name
            sources.append((label, registry_from_json(data)))
    return merge_registries(sources)


def _emit_registry(reg, fmt: str) -> None:
    if fmt == "json":
        print(json.dumps(reg.to_json(), indent=2))
    else:
        print(reg.to_prometheus(), end="")


def cmd_stats(args) -> int:
    """Offline metrics exposition (the JAX package's ``cmd_stats``):
    re-emit a finished run's snapshot (``metrics.json``, written at run
    end) as Prometheus text or JSON, and summarize the run journal when
    asked. ``--diff`` takes two targets and emits after-minus-before
    deltas (counters and histograms subtract; gauges keep the after
    reading). ``--merge`` federates N snapshots (counters and histogram
    buckets sum, gauges gain a ``host`` label) and composes with
    ``--diff``: two targets, each merged, then diffed."""
    import os

    from .obs import diff_registries, read_journal, registry_from_json
    from .obs.journal import JOURNAL_NAME

    if args.merge:
        if args.diff and len(args.target) != 2:
            print(
                "--merge --diff takes exactly two targets (each a "
                "fleet dir / snapshot list member): "
                "`cli stats --merge --diff before_fleet/ after_fleet/`",
                file=sys.stderr,
            )
            return 2
        if args.diff:
            regs = [_merge_targets([t]) for t in args.target]
            if any(r is None for r in regs):
                return 2
            out = diff_registries(regs[0], regs[1])
        else:
            out = _merge_targets(args.target)
            if out is None:
                return 2
        _emit_registry(out, args.format)
        return 0
    if args.diff:
        if len(args.target) != 2:
            print(
                "--diff takes exactly two targets: "
                "`cli stats --diff before/ after/`",
                file=sys.stderr,
            )
            return 2
        snaps = [_load_snapshot(Path(t)) for t in args.target]
        if any(s is None for s in snaps):
            return 2
        _emit_registry(
            diff_registries(registry_from_json(snaps[0]), registry_from_json(snaps[1])),
            args.format,
        )
        return 0
    if len(args.target) != 1:
        print("stats takes one target (or two with --diff)", file=sys.stderr)
        return 2
    target = Path(args.target[0])
    data = _load_snapshot(target)
    if data is None:
        return 2
    if args.format == "json":
        print(json.dumps(data, indent=2))
    else:
        # Through the registry, so the text form comes from the same
        # exposition code the live endpoint uses.
        print(registry_from_json(data).to_prometheus(), end="")
    if args.journal:
        jpath = (
            target / JOURNAL_NAME
            if target.is_dir()
            else target.parent / JOURNAL_NAME
        )
        events = read_journal(jpath)
        if events:
            windows = [e for e in events if e["event"] == "window"]
            ranked = [w for w in windows if w.get("outcome") == "ranked"]
            contended = sum(
                1 for w in windows if (w.get("host") or {}).get("contended")
            )
            # This package's journal is one file (no rotated parts).
            print(
                f"# journal: {len(windows)} windows ({len(ranked)} "
                f"ranked), {contended} contended samples, "
                f"{os.path.getsize(jpath)} bytes",
                file=sys.stderr,
            )
    return 0


def _report_dict(rep) -> dict:
    """The JSON shape of every eval report (the JAX CLI's)."""
    return {
        "recall_at": rep.recall_at,
        "exam_score": rep.exam_score,
        # The paper's unnormalized Exam form (Tables 4-6).
        "exam_score_paper": rep.exam_score_paper,
        "detection_rate": rep.detection_rate,
    }


def cmd_eval(args) -> int:
    """The accuracy experiment (``evaluation``), printed and written as
    the JAX CLI's ``cmd_eval`` prints and writes it."""
    from .evaluation import (
        EvalConfig,
        evaluate,
        evaluate_all_methods,
        evaluate_detection,
        evaluate_overlap_ablation,
    )

    cfg = _config_from_args(args)
    eval_cfg = EvalConfig(
        n_cases=args.cases,
        n_operations=args.operations,
        n_traces=args.traces,
        n_pods=args.pods,
        n_kinds=args.kinds,
        child_keep_prob=args.keep_prob,
        n_faults=args.faults,
        fault_latency_ms=args.fault_ms,
        fault_path_overlap=args.fault_overlap,
        seed0=args.seed,
    )
    if args.overlap_ablation:
        reports = evaluate_overlap_ablation(cfg, eval_cfg)
        for ov, rep in reports.items():
            print(f"overlap={ov:.2f}  {rep.summary()}")
        if args.json:
            out = {str(ov): _report_dict(rep) for ov, rep in reports.items()}
            Path(args.json).write_text(json.dumps(out, indent=2))
        return 0
    if args.detection:
        report = evaluate_detection(cfg, eval_cfg, n_windows=args.windows)
        print(report.summary())
        if args.json:
            Path(args.json).write_text(json.dumps({
                "precision": report.precision, "recall": report.recall, "f1": report.f1,
                "tp": report.tp, "fp": report.fp, "fn": report.fn, "tn": report.tn,
            }, indent=2))
        return 0
    if args.all_methods:
        reports = evaluate_all_methods(cfg, eval_cfg)
        width = max(len(m) for m in reports)
        for m, rep in reports.items():
            print(f"{m:<{width}}  {rep.summary()}")
        if args.json:
            out = {m: _report_dict(rep) for m, rep in reports.items()}
            Path(args.json).write_text(json.dumps(out, indent=2))
        return 0
    report = evaluate(cfg, eval_cfg)
    print(report.summary())
    if args.json:
        out = {
            **_report_dict(report),
            "cases": [{"seed": c.seed, "faults": c.faults, "ranks": c.ranks}
                      for c in report.cases],
        }
        Path(args.json).write_text(json.dumps(out, indent=2))
    return 0


def cmd_synth(args) -> int:
    from .testing import SyntheticConfig, generate_case

    case = generate_case(
        SyntheticConfig(
            n_operations=args.operations,
            n_pods=args.pods,
            n_kinds=args.kinds,
            n_traces=args.traces,
            fault_latency_ms=args.fault_ms,
            seed=args.seed,
        )
    )
    out = Path(args.output)
    normal, abnormal = case.write_csvs(out)
    truth = {
        "fault_service_op": case.fault_service_op,
        "fault_pod_op": case.fault_pod_op,
        "fault_op": case.fault_op,
        "fault_pod": case.fault_pod,
        "n_abnormal_spans": case.n_abnormal_spans,
    }
    (out / "ground_truth.json").write_text(json.dumps(truth, indent=2))
    print(f"wrote {normal} and {abnormal} (fault: {case.fault_pod_op})")
    return 0


def _add_ranking_flags(p: argparse.ArgumentParser) -> None:
    """The JAX CLI's ranking and detection flags, with its names,
    defaults and choices (``microrank_tpu/cli/main.py``
    ``_add_config_flags``)."""
    p.add_argument("--spectrum-method", default="dstar2")
    p.add_argument("--top-max", type=int, default=5)
    p.add_argument("--iterations", type=int, default=25)
    p.add_argument("--damping", type=float, default=0.85)
    p.add_argument("--call-weight", type=float, default=0.01)
    p.add_argument("--preference", default="reference", choices=["reference", "paper"])
    p.add_argument("--k-sigma", type=float, default=3.0)
    p.add_argument("--slack-ms", type=float, default=0.0)
    p.add_argument(
        "--slo-stat", default="mean",
        help='SLO central statistic: "mean" or a percentile like "p90"',
    )
    p.add_argument("--detect-minutes", type=float, default=5.0)
    p.add_argument("--skip-minutes", type=float, default=4.0)
    p.add_argument(
        "--reference-compat", action="store_true",
        help="reproduce the reference code exactly, documented quirks "
        "included (partition swap, overwritten result.csv)",
    )


def _add_config_flags(p: argparse.ArgumentParser) -> None:
    """The flags every subcommand that builds a ``MicroRankConfig``
    takes (``_config_from_args``): the device, the kernel and build
    knobs, the ranking and detection flags, the window loop's knobs,
    the span tracer's and the dead-letter store's."""
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument(
        "--collapse-kinds", default="auto", choices=["auto", "on", "off"]
    )
    p.add_argument(
        "--kernel", default="auto", choices=list(KERNELS),
        help="power-iteration kernel ('kind' = kind-compressed "
        "reduced-precision iteration over the collapsed trace-kind "
        "axis; 'auto' selects it when the measured dedup factor "
        "clears --kind-dedup-threshold)",
    )
    p.add_argument(
        "--kind-precision", default=None, choices=list(KIND_PRECISIONS),
        help="kernel='kind' coverage matvec precision: f32 (default), bf16 "
        "operands with f32 accumulation, or scaled-int8 operands with "
        "exact int32 accumulation",
    )
    _add_ranking_flags(p)
    p.add_argument(
        "--kind-dedup-threshold", type=float, default=None,
        help="measured window dedup factor (true traces / distinct kinds) "
        "past which kernel='auto' selects the kind kernel (default 4.0)",
    )
    p.add_argument(
        "--sync-dispatch", action="store_true",
        help="disable the async stage/fetch worker threads (default on: "
        "the dispatch and the result wait overlap the next window's host "
        "work)",
    )
    p.add_argument(
        "--pipeline-depth", type=_positive_int, default=None,
        help="device rank programs allowed in flight (1 = synchronous)",
    )
    p.add_argument(
        "--fetch-mode", choices=list(FETCH_MODES), default=None,
        help="result joins: per window ('stream', lowest sink latency) or "
        "over --bulk-fetch-windows windows at once ('bulk'; supersedes "
        "--pipeline-depth as the in-flight bound)",
    )
    p.add_argument(
        "--bulk-fetch-windows", type=_positive_int, default=None,
        help="windows joined at once in --fetch-mode bulk",
    )
    p.add_argument(
        "--dispatch-batch-windows", type=_positive_int, default=None,
        help="group this many anomalous windows into one stacked "
        "stage+dispatch (one staging transfer per group — the replay "
        "throughput knob on high-latency links; 1 = lowest per-window "
        "latency)",
    )
    p.add_argument(
        "--no-blob-staging", action="store_true",
        help="stage graphs as per-leaf transfers instead of one packed "
        "uint32 buffer",
    )
    p.add_argument(
        "--device-checks", action="store_true",
        help="assert the finite-score invariant INSIDE the compiled "
        "program (checkify; forces synchronous dispatch)",
    )
    p.add_argument(
        "--no-tuned-policy", action="store_true",
        help="do not consult the persisted tuned policy (policy.json, "
        "written by the JAX package's `cli scenarios` next to its "
        "compile cache, or in $MICRORANK_POLICY_DIR); pins the built-in "
        "spectrum/kernel/pad defaults. Explicit flags always beat the "
        "policy even without this",
    )
    p.add_argument(
        "--quarantine-dir", default=None,
        help="directory for the span-admission dead-letter store "
        "(quarantine.jsonl — every rejected row with its reason; "
        "default: the run's output directory)",
    )
    p.add_argument(
        "--no-span-trace", action="store_true",
        help="disable the self-tracing span ring (obs.spans; on by "
        "default — every pipeline stage emits a parent-linked span "
        "the flight recorder can dump)",
    )
    p.add_argument(
        "--span-ring", type=_positive_int, default=None,
        help="span ring capacity (spans; default 8192 — oldest spans "
        "fall off, the flight manifest counts drops)",
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m microrank_tpu_torch.cli")
    sub = p.add_subparsers(dest="cmd", required=True)

    p_run = sub.add_parser("run", help="RCA over a normal / abnormal trace dump pair")
    p_run.add_argument("--normal", required=True, help="normal-period traces.csv")
    p_run.add_argument("--abnormal", required=True, help="traces.csv to analyze")
    p_run.add_argument("-o", "--output", default="rca_out")
    _add_config_flags(p_run)
    p_run.add_argument("--slo-cache", help="npz path to cache the SLO baseline")
    p_run.add_argument(
        "--resume", action="store_true", help="resume from the window cursor"
    )
    p_run.add_argument(
        "--follow", action="store_true",
        help="online mode: tail the (growing) --abnormal CSV and rank "
        "windows as they close; the window cursor in -o makes polls "
        "and restarts incremental",
    )
    p_run.add_argument(
        "--poll-seconds", type=float, default=5.0,
        help="--follow: seconds between file polls",
    )
    p_run.add_argument(
        "--follow-grace-seconds", type=float, default=0.0,
        help="--follow: hold a window open this long past its end for "
        "straggler spans before ranking it",
    )
    p_run.add_argument(
        "--follow-idle-exit", type=_positive_int, default=None,
        help="--follow: exit after this many consecutive polls without "
        "file growth (default: follow forever)",
    )
    p_run.add_argument(
        "--metrics-port", type=int, default=None,
        help="serve live telemetry over HTTP on this port (127.0.0.1): "
        "/metrics (Prometheus text), /metrics.json, /healthz; 0 picks "
        "a free port. The snapshot is also written to -o at run end "
        "for offline `stats`",
    )
    p_run.set_defaults(fn=cmd_run)

    p_stats = sub.add_parser(
        "stats",
        help="re-emit a finished run's metrics snapshot (Prometheus "
        "text or JSON) and summarize its journal",
    )
    p_stats.add_argument(
        "target",
        nargs="+",
        help="a run output directory (reads metrics.json there) or a "
        "metrics.json path; with --diff, exactly two of these "
        "(before after)",
    )
    p_stats.add_argument(
        "--diff", action="store_true",
        help="emit after-minus-before metric deltas between TWO "
        "targets (counters/histograms subtract, gauges keep the "
        "after reading)",
    )
    p_stats.add_argument(
        "--merge", action="store_true",
        help="federate N per-host snapshots into one view (counters and "
        "histogram buckets sum, gauges gain a host label); a directory "
        "with host*/metrics.json children expands to them; composes "
        "with --diff (two targets, each merged)",
    )
    p_stats.add_argument(
        "--format", choices=["prom", "json"], default="prom",
        help="exposition format (default: Prometheus text)",
    )
    p_stats.add_argument(
        "--journal", action="store_true",
        help="also print a one-line journal summary to stderr",
    )
    p_stats.set_defaults(fn=cmd_stats)

    p_eval = sub.add_parser(
        "eval",
        help="R@k / Exam-Score accuracy experiment over synthetic chaos "
        "cases (the paper's Tables 4-6 methodology, reproducible)",
    )
    p_eval.add_argument("--cases", type=int, default=20)
    p_eval.add_argument("--operations", type=int, default=30)
    p_eval.add_argument("--traces", type=int, default=400)
    p_eval.add_argument("--pods", type=int, default=1)
    p_eval.add_argument("--kinds", type=int, default=48)
    p_eval.add_argument("--faults", type=int, default=1)
    p_eval.add_argument("--fault-ms", type=float, default=2000.0)
    p_eval.add_argument(
        "--keep-prob", type=float, default=0.15,
        help="per-kind subtree keep probability: trace-kind breadth "
        "(lower = narrower, more request-like traces)",
    )
    p_eval.add_argument(
        "--fault-overlap", type=float, default=None,
        help="target root-path overlap between injected faults "
        "(multi-fault hardness control, 0=disjoint paths, 1=nested)",
    )
    p_eval.add_argument(
        "--overlap-ablation", action="store_true",
        help="sweep --fault-overlap over 0, 0.25, 0.5, 0.75, 1 "
        "(two-fault hardness ablation)",
    )
    p_eval.add_argument("--seed", type=int, default=1000)
    p_eval.add_argument(
        "--all-methods", action="store_true",
        help="score every spectrum formula (one rank program per case)",
    )
    p_eval.add_argument(
        "--detection", action="store_true",
        help="window-level detection precision/recall/F1 over timelines "
        "(the paper's Fig. 9 experiment)",
    )
    p_eval.add_argument(
        "--windows", type=int, default=10,
        help="timeline length for --detection (half the windows faulted)",
    )
    p_eval.add_argument("--json", help="write the detailed report here")
    p_eval.add_argument(
        "--backend", default="torch", choices=list(BACKENDS),
        help="ranking backend: this package's device program; numpy_ref (the "
        "JAX package's oracle) is not ported and raises",
    )
    _add_config_flags(p_eval)
    p_eval.set_defaults(fn=cmd_eval)

    p_synth = sub.add_parser("synth", help="generate a synthetic chaos case")
    p_synth.add_argument("-o", "--output", required=True)
    p_synth.add_argument("--operations", type=int, default=40)
    p_synth.add_argument("--pods", type=int, default=1)
    p_synth.add_argument("--kinds", type=int, default=24)
    p_synth.add_argument("--traces", type=int, default=500)
    p_synth.add_argument("--fault-ms", type=float, default=2000.0)
    p_synth.add_argument("--seed", type=int, default=0)
    p_synth.set_defaults(fn=cmd_synth)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(levelname)-7s %(name)s: %(message)s"
    )
    args = build_parser().parse_args(argv)
    return int(args.fn(args))


if __name__ == "__main__":
    sys.exit(main())
