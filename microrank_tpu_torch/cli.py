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
    python -m microrank_tpu_torch.cli serve --normal N [--dataset NAME=CSV ...] [-o OUT]
        [--host H] [--port P] [--max-queue-depth N] [--retry-after S]
        [--max-batch-windows N] [--max-wait-ms MS] [--request-timeout S]
        [--drain-seconds S] [--no-warmup] [--warmup-occupancies N,N]
        [--build-workers N] [--no-fallback] [--inject-dispatch-failures N]
        [--stream-input CSV] [--tenant-weight NAME=W] [--tenant-rate NAME=R]
        [--backfill WAREHOUSE [--backfill-range START..END]]
        [--device cuda|cpu] [the config flags of run]
    python -m microrank_tpu_torch.cli stream [--source synthetic|tail|replay] [-o OUT]
        [--resume] [--warehouse] [--warehouse-dir DIR] [--chaos PLAN.json] [...]
    python -m microrank_tpu_torch.cli replay TARGET --at RANGE [-k K] [--json PATH]
        [the config flags of run]
    python -m microrank_tpu_torch.cli scenarios --from-warehouse DIR [--seed N]
        [--no-persist-policy] [--json PATH] [the config flags of run]
    python -m microrank_tpu_torch.cli stats OUT [OUT2] [--diff] [--merge]
        [--format prom|json] [--journal]
    python -m microrank_tpu_torch.cli synth -o DIR [--operations 40 ...]
    python -m microrank_tpu_torch.cli explain TARGET [--window START] [--format table|json]
        [--json PATH]
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
``serve`` answers ``POST /rank`` windows (a staged dataset's time range
or inline spans) over HTTP on 127.0.0.1, coalescing concurrent requests
into stacked rank programs; SIGTERM drains it.
``stream --explain`` writes an explain bundle when an incident opens;
``explain`` renders one from a run directory, a bundle directory or
file, a flight dump or a journal (JAX's ``cli explain``).
``stream --resume`` continues a killed run from its checkpoint;
``--warehouse`` seals every closed window into ``OUT/warehouse``;
``--chaos PLAN.json`` (every subcommand with the config flags) arms the
fault plan. ``replay`` re-ranks stored windows from their blobs and
checks them against the stored verdicts (exit 1 on a mismatch, 2 on a
bad range); ``scenarios --from-warehouse`` scores the stored incidents
under all 13 formulas and persists the selected policy; ``serve
--backfill`` replays a warehouse on the device scheduler's backfill
lane beside the service.
"""

from __future__ import annotations

import argparse
import dataclasses
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
    ChaosConfig,
    CompatConfig,
    DetectorConfig,
    ExplainConfig,
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
    explain = {k: v for k, v in (("enabled", True if args.explain else None),
                                 ("top_traces", args.explain_top_traces)) if v is not None}
    chaos = {} if not args.chaos else {"enabled": True, "plan_path": args.chaos}
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
        explain=ExplainConfig(**explain),
        chaos=ChaosConfig(**chaos),
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


# Stream flags of the JAX CLI whose lanes are not ported, and the item
# that brings each (ROADMAP.md, port queue).
_STREAM_REFUSED = (
    ("mesh", "--mesh (the sharded route) comes with item 12"),
    ("fleet", "--fleet comes with item 11's fleet slice"),
    ("fleet_role", "--fleet-role comes with item 11's fleet slice"),
    ("delta_build", "--delta-build (the incremental build) is item 11's, set aside in "
                    "ROADMAP.md"),
)


def cmd_stream(args) -> int:
    """The continuous RCA engine (``stream.engine``): a span source feeds
    the event-time windower; online SLO baselines arm the detector on
    every closed window; only abnormal windows are built and ranked on
    the card; ranked windows dedup into incidents (JAX's ``cmd_stream``
    over the table lane)."""
    from .stream import (
        FileTailSource,
        ReplaySource,
        StdoutIncidentSink,
        StreamEngine,
        SyntheticSource,
    )

    for name, why in _STREAM_REFUSED:
        if getattr(args, name, None):
            raise NotImplementedError(f"{why}: ROADMAP.md, port queue")
    if args.fault_kind != "latency" or args.drift:
        raise NotImplementedError(
            "--fault-kind error and --drift (the error and drift fault families) are not "
            "ported: ROADMAP.md, port queue item 11")
    cfg = _config_from_args(args)
    overrides = {k: v for k, v in {
        "window_minutes": args.detect_minutes,
        "slide_minutes": args.slide_minutes,
        "allowed_lateness_seconds": args.lateness_seconds,
        "baseline_decay": args.baseline_decay,
        "min_healthy_windows": args.min_healthy_windows,
        "resolve_after_windows": args.resolve_after,
        "cooldown_windows": args.cooldown,
        "fingerprint_top_k": args.fingerprint_top_k,
        "build_workers": args.build_workers,
        "pipeline_windows": args.pipeline_windows,
        "webhook_url": args.webhook,
        "max_windows": args.max_windows,
    }.items() if v is not None}
    cfg = cfg.replace(stream=dataclasses.replace(cfg.stream, **overrides))
    if args.warehouse or args.warehouse_dir:
        cfg = cfg.replace(warehouse=dataclasses.replace(cfg.warehouse, enabled=True,
                                                        dir=args.warehouse_dir))
    rt = {k: True for k in ("warm_start", "fused_pair") if getattr(args, k)}
    if rt:
        cfg = cfg.replace(runtime=dataclasses.replace(cfg.runtime, **rt))
    if args.source == "synthetic":
        from .testing import SyntheticConfig

        faulted = [int(x) for x in (args.fault_windows or "").split(",") if x.strip()]
        source = SyntheticSource(
            n_windows=args.windows, faulted=faulted,
            synth_config=SyntheticConfig(
                n_operations=args.operations, n_pods=args.pods, n_kinds=args.kinds,
                n_traces=args.traces, fault_latency_ms=args.fault_ms,
                n_faults=args.fault_count, window_minutes=args.detect_minutes, seed=args.seed,
            ),
            chunk_spans=args.chunk_spans, pace_seconds=args.pace_seconds,
        )
        log.info("synthetic source: %d windows, fault windows %s, injected latency fault(s) %s",
                 args.windows, faulted or "none", source.fault_pod_ops)
    elif args.input is None:
        log.error("--source %s needs --input TRACES_CSV", args.source)
        return 2
    elif args.source == "replay":
        source = ReplaySource(args.input, chunk_spans=args.chunk_spans,
                              pace_seconds=args.pace_seconds, rate=args.rate)
    else:  # tail
        source = FileTailSource(args.input, poll_seconds=args.poll_seconds,
                                idle_exit=args.idle_exit or 0)
    normal_table = None
    if args.normal:
        from .stream.sources import load_table

        normal_table = load_table(args.normal)
    if args.metrics_port is not None:
        from .obs.server import start_metrics_server

        server = start_metrics_server(args.metrics_port)
        log.info("metrics endpoint: http://127.0.0.1:%d/metrics", server.port)
    engine = StreamEngine(cfg, source, out_dir=args.output, normal_table=normal_table,
                          incident_sinks=[StdoutIncidentSink()], resume=args.resume)
    # SIGTERM drains the engine at the next batch and writes a final
    # checkpoint: the run continues under --resume.
    import signal

    def _on_sigterm(_signo, _frame):
        log.info("SIGTERM: draining the stream engine (checkpoint on exit)")
        engine.request_stop()

    try:
        previous = signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:  # not the main thread (an embedding caller)
        previous = None
    try:
        s = engine.run()
    finally:
        if previous is not None:   # an embedding caller gets its handler back
            signal.signal(signal.SIGTERM, previous)
    _print_windows(s.results)
    log.info(
        "stream done: %d windows (%d ranked, %d clean, %d empty, %d skipped, %d warmup), "
        "%d gated dispatches, %d late spans dropped, incidents %d opened / %d resolved; "
        "results in %s",
        s.windows, s.ranked, s.clean, s.empty, s.skipped, s.warmup, s.dispatches,
        s.late_spans, s.incidents_opened, s.incidents_resolved, args.output,
    )
    return 0


# Serve flags of the JAX CLI whose lanes are not ported, and the item
# that brings each (ROADMAP.md, port queue).
_SERVE_REFUSED = (
    ("mesh", "--mesh (the sharded route) comes with item 12"),
)


def _parse_tenant_floats(specs, flag: str):
    """Repeatable ``NAME=FLOAT`` flags -> the SchedConfig pair tuple."""
    out = []
    for spec in specs or ():
        name, sep, val = spec.partition("=")
        if not name or not sep:
            raise SystemExit(f"{flag} takes NAME=FLOAT, got {spec!r}")
        try:
            out.append((name, float(val)))
        except ValueError:
            raise SystemExit(f"{flag}: {val!r} is not a number (in {spec!r})") from None
    return tuple(out)


def cmd_serve(args) -> int:
    """The online RCA service (``serve/``, JAX's ``cmd_serve``): windows
    over HTTP, concurrent requests coalesced into stacked rank programs
    on the card, the numpy_ref oracle (marked ``degraded``) when a device
    dispatch fails twice. ``--stream-input`` co-deploys a stream engine
    tailing a growing trace file through one device scheduler
    (``sched/``): open-incident work preempts serve, under per-tenant
    weighted fair share (``--tenant-weight``) and soft quotas
    (``--tenant-rate``). ``--backfill`` replays a warehouse
    (``warehouse.replay_range``) on the scheduler's backfill lane, behind
    both."""
    import threading

    from .native import load_span_table
    from .serve import ServeService, run_serve

    for name, why in _SERVE_REFUSED:
        if getattr(args, name, None):
            raise NotImplementedError(f"{why}: ROADMAP.md, port queue")
    cfg = _config_from_args(args)
    overrides = {k: v for k, v in {
        "host": args.host,
        "port": args.port,
        "max_queue_depth": args.max_queue_depth,
        "retry_after_seconds": args.retry_after,
        "max_batch_windows": args.max_batch_windows,
        "max_wait_ms": args.max_wait_ms,
        "request_timeout_seconds": args.request_timeout,
        "drain_seconds": args.drain_seconds,
        "warmup_occupancies": (
            tuple(int(x) for x in args.warmup_occupancies.split(",") if x.strip())
            if args.warmup_occupancies else None),
        "build_workers": args.build_workers,
        "warmup": False if args.no_warmup else None,
        "fallback": False if args.no_fallback else None,
        "inject_dispatch_failures": args.inject_dispatch_failures,
    }.items() if v is not None}
    cfg = cfg.replace(serve=dataclasses.replace(cfg.serve, **overrides))
    sched_overrides = {}
    if args.tenant_weight:
        sched_overrides["tenant_weights"] = _parse_tenant_floats(args.tenant_weight,
                                                                 "--tenant-weight")
    if args.tenant_rate:
        sched_overrides["tenant_rates"] = _parse_tenant_floats(args.tenant_rate, "--tenant-rate")
    if sched_overrides:
        cfg = cfg.replace(sched=dataclasses.replace(cfg.sched, **sched_overrides))

    datasets = []
    for spec in args.dataset or ():
        name, _, path = spec.partition("=")
        if not name or not path:
            log.error("--dataset takes NAME=CSV_PATH, got %r", spec)
            return 2
        datasets.append((name, path))
    if args.backfill_range and not args.backfill:
        log.error("--backfill-range needs --backfill WAREHOUSE_DIR")
        return 2
    t_range = (None, None)
    if args.backfill:
        from .warehouse import parse_time_range

        try:
            t_range = parse_time_range(args.backfill_range or "all")
        except ValueError as exc:
            log.error("bad --backfill-range %r: %s", args.backfill_range, exc)
            return 2
    sched = None
    if args.stream_input or args.backfill:
        from .sched import DeviceScheduler, ParkedWindowStore

        sched = DeviceScheduler(ParkedWindowStore(cfg.sched, serve_cfg=cfg.serve))
        sched.start()
        log.info("co-deploy: device scheduler up (lanes: incident > serve > backfill)")
    normal_table = load_span_table(args.normal, cache=False)
    service = ServeService(cfg, out_dir=args.output, sched=sched)
    service.fit_baseline(normal_table)
    for name, path in datasets:
        service.add_dataset(name, load_span_table(path, cache=False))

    engine = thread = None
    side_threads = []
    if args.backfill:
        from .warehouse import replay_range

        backfill_report = {}

        def _backfill():
            backfill_report.update(replay_range(args.backfill, *t_range, config=cfg, sched=sched))
            log.info("co-deploy backfill done: verdict=%s ranked=%d matched=%d",
                     backfill_report["verdict"], backfill_report["ranked"],
                     backfill_report["matched"])
            if args.output:
                Path(args.output).mkdir(parents=True, exist_ok=True)
                (Path(args.output) / "backfill.json").write_text(
                    json.dumps(backfill_report, indent=2))

        t = threading.Thread(target=_backfill, name="co-backfill", daemon=True)
        t.start()
        side_threads.append(t)
        log.info("co-deploy: warehouse backfill of %s on the backfill lane", args.backfill)
    if args.stream_input:
        from .stream import FileTailSource, StreamEngine

        stream_out = str(Path(args.output) / "stream") if args.output else None
        engine = StreamEngine(cfg, FileTailSource(args.stream_input), out_dir=stream_out,
                              normal_table=normal_table, sched=sched)
        thread = threading.Thread(target=engine.run, name="co-stream", daemon=True)
        thread.start()
        log.info("co-deploy: stream engine tailing %s (the incident lane preempts serve)",
                 args.stream_input)
    service.start()
    rc = run_serve(service, cfg.serve.host, cfg.serve.port)
    if thread is not None:
        engine.request_stop()
        thread.join(timeout=30)
    for t in side_threads:
        t.join(timeout=30)
    if sched is not None:
        sched.stop(drain=True, timeout=30)
    return rc


def cmd_replay(args) -> int:
    """Time-travel RCA (``warehouse/``, JAX's ``cmd_replay``): re-rank the
    stored windows of a time range through the dispatch router from
    their blobs (no parse, no build) and check each new ranking against
    the stored verdict, tie-aware. Exit 1 on a mismatch, 2 on a bad
    range."""
    from .warehouse import parse_time_range, replay_range

    cfg = _config_from_args(args)
    try:
        t0_us, t1_us = parse_time_range(args.at)
    except (ValueError, TypeError) as exc:
        log.error("bad --at range %r: %s", args.at, exc)
        return 2
    report = replay_range(args.target, t0_us, t1_us, config=cfg, k=args.top)
    rng = args.at if args.at not in ("", "*") else "all"
    print(f"replay --at {rng}: {report['ranked']}/{report['windows']} windows re-ranked, "
          f"{report['matched']} matched, {len(report['mismatched'])} mismatched "
          f"({report['spans']} spans in {report['elapsed_s']}s"
          + (f", {report['spans_per_sec']} spans/s" if report["spans_per_sec"] is not None
             else "")
          + f") -> {report['verdict']}")
    for mm in report["mismatched"]:
        print(f"  MISMATCH {mm['start']}..{mm['end']}: {mm['reason']}")
        print(f"    stored:   {mm['stored_top']}")
        print(f"    replayed: {mm['replayed_top']}")
    if report["skipped_no_blob"]:
        log.warning("%d ranked window(s) stored without rank blobs were skipped (run with "
                    "warehouse.store_blobs=true to make history replayable)",
                    report["skipped_no_blob"])
    if args.json:
        Path(args.json).write_text(json.dumps(report, indent=2))
    return 0 if report["verdict"] == "match" else 1


def cmd_scenarios(args) -> int:
    """The scenario lane of the policy engine (JAX's ``cmd_scenarios``):
    ``--from-warehouse`` scores a stored run's incidents under all 13
    formulas (K13 a window) against the recorded truth and persists the
    selected policy. The synthetic matrix needs the error, cascade and
    drift fault families: not ported."""
    if not args.from_warehouse:
        raise NotImplementedError(
            "cli scenarios without --from-warehouse (the synthetic scenario matrix: the "
            "error, cascade and drift fault families) is item 11's scenarios remainder: "
            "ROADMAP.md, port queue")
    from .warehouse import render_retro_table, run_retro

    cfg = _config_from_args(args)
    result = run_retro(args.from_warehouse, config=cfg, seed=args.seed,
                       persist_policy=not args.no_persist_policy)
    print(render_retro_table(result))
    if args.json:
        Path(args.json).write_text(json.dumps(result, indent=2))
    if not result["record"]["formulas"]:
        log.error("warehouse %s: no stored ranked windows to score", args.from_warehouse)
        return 1
    return 0


def _find_bundles(target: Path):
    """An explain target (a bundle .json, a run output dir, a flight
    dump dir, or a journal .jsonl) as a list of bundle dicts, searched in
    JAX's order: the file itself, explain_bundle.json, explain/*/ bundle
    dirs, then the journal's (or the dump's events') ``explain`` records
    (``{"journal_record": event}`` where the bundle file is gone)."""
    from .explain.bundle import BUNDLE_JSON, ExplainBundle
    from .obs import read_journal

    bundles = []
    if target.is_file():
        if target.name.endswith(".jsonl"):
            for e in read_journal(target):
                if e.get("event") == "explain":
                    bpath = e.get("bundle")
                    if bpath and Path(bpath).exists():
                        bundles.append(ExplainBundle.load(bpath).data)
                    else:
                        bundles.append({"journal_record": e})
            return bundles
        return [ExplainBundle.load(target).data]
    if (target / BUNDLE_JSON).exists():
        return [ExplainBundle.load(target / BUNDLE_JSON).data]
    exp_dir = target / "explain"
    if exp_dir.is_dir():
        for sub in sorted(exp_dir.iterdir()):
            if (sub / BUNDLE_JSON).exists():
                bundles.append(ExplainBundle.load(sub / BUNDLE_JSON).data)
        if bundles:
            return bundles
    for journal_name in ("journal.jsonl", "events.jsonl"):
        if (target / journal_name).exists():
            bundles.extend(_find_bundles(target / journal_name))
            if bundles:
                return bundles
    return bundles


def cmd_explain(args) -> int:
    """Render rank provenance from run artifacts: the bundles the stream
    engine writes when an incident opens, the journal's ``explain``
    events, or a flight dump's bundle — the offline twin of ``GET
    /explainz`` (JAX's ``cmd_explain``; exit 2 when nothing matches)."""
    from .explain.bundle import ExplainBundle

    target = Path(args.target)
    if not target.exists():
        print(f"no such explain target: {target}", file=sys.stderr)
        return 2
    bundles = _find_bundles(target)
    if not bundles:
        print(f"no explain bundles under {target} (run stream with --explain)", file=sys.stderr)
        return 2
    if args.window is not None:
        bundles = [b for b in bundles
                   if str((b.get("window") or {}).get("start")
                          or (b.get("journal_record") or {}).get("start")) == str(args.window)]
        if not bundles:
            print(f"no bundle for window {args.window!r}", file=sys.stderr)
            return 2
    data = bundles[-1]
    if "journal_record" in data:
        # The journal's compact record only (the bundle file is gone).
        print(json.dumps(data["journal_record"], indent=2))
        return 0
    if args.json:
        Path(args.json).write_text(json.dumps(data, indent=2))
    if args.format == "json":
        print(json.dumps(data, indent=2))
    else:
        print(ExplainBundle(data).to_table(), end="")
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
    p.add_argument(
        "--explain", action="store_true",
        help="arm the rank-provenance subsystem (explain/): stream "
        "builds an explain bundle automatically when an incident "
        "opens (written next to the flight dump, served at "
        "/explainz); off by default — the hot path pays nothing",
    )
    p.add_argument(
        "--explain-top-traces", type=_positive_int, default=None,
        help="contributing coverage columns (traces) kept per suspect "
        "in explain bundles (default 5)",
    )
    p.add_argument(
        "--chaos", default=None, metavar="PLAN.json",
        help="arm the unified fault-injection harness (chaos/): a "
        'seeded JSON fault plan ({"seed": N, "faults": [{"seam": ..., '
        '"kind": ..., ...}]}) injected deterministically at every '
        "instrumented seam — dispatch/build/source/webhook/checkpoint/"
        "fetch; injections land in "
        "microrank_fault_injections_total and the journal",
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

    p_stream = sub.add_parser(
        "stream", help="continuous RCA: event-time windows, online SLO baselines, "
        "detector-gated ranking on the card, incident lifecycle")
    p_stream.add_argument("--source", default="synthetic", choices=["synthetic", "tail", "replay"],
                          help="span source: in-process synthetic stream, tail a growing CSV, "
                          "or staged-CSV replay with pacing")
    p_stream.add_argument("--input", help="traces CSV for --source tail / replay (replay: or a "
                          "warehouse directory, its stored span tables)")
    p_stream.add_argument("--normal", help="normal-period traces.csv (or a warehouse directory) "
                          "seeding the online baseline "
                          "(else it cold-starts from the first --min-healthy-windows windows; "
                          "the synthetic source seeds from its own normal window)")
    p_stream.add_argument("-o", "--output", default="stream_out")
    p_stream.add_argument("--resume", action="store_true",
                          help="continue a killed or drained run from OUT/state.ckpt (the "
                          "baseline, open incidents, the windower and the source cursor); a "
                          "corrupt checkpoint is rejected whole and the run cold-starts")
    p_stream.add_argument("--slide-minutes", type=float, default=None,
                          help="sliding windows (default: tumbling, slide = --detect-minutes)")
    p_stream.add_argument("--lateness-seconds", type=float, default=None,
                          help="watermark lag: how long past its end a window waits for late "
                          "spans before it closes (later spans are dropped and counted)")
    p_stream.add_argument("--baseline-decay", type=float, default=None,
                          help="exponential-decay weight of one healthy window in the online "
                          "SLO baseline")
    p_stream.add_argument("--min-healthy-windows", type=_positive_int, default=None,
                          help="cold-start windows fed to the baseline before detection arms "
                          "(ignored when the baseline is seeded)")
    p_stream.add_argument("--resolve-after", type=_positive_int, default=None,
                          help="consecutive healthy windows that resolve an incident")
    p_stream.add_argument("--cooldown", type=int, default=None,
                          help="windows after a resolve during which the same fingerprint is "
                          "suppressed instead of reopened (flap damping)")
    p_stream.add_argument("--fingerprint-top-k", type=_positive_int, default=None,
                          help="suspects in the tie-aware fingerprint of a ranked window")
    p_stream.add_argument("--build-workers", type=int, default=None,
                          help="host graph-build threads overlapping the ranking on the card")
    p_stream.add_argument("--webhook", help="POST every incident transition here (JSON)")
    p_stream.add_argument("--pipeline-windows", type=_positive_int, default=None,
                          help="abnormal windows in flight (build submitted, rank pending) "
                          "before the engine ranks the head; also the burst depth the "
                          "router's coalescing can take")
    p_stream.add_argument("--mesh", default=None, help="not ported: the sharded route (item 12)")
    p_stream.add_argument("--max-windows", type=int, default=None,
                          help="stop after this many closed windows (default: until the "
                          "source ends)")
    p_stream.add_argument("--pace-seconds", type=float, default=0.0,
                          help="sleep between source chunks")
    p_stream.add_argument("--chunk-spans", type=_positive_int, default=5000,
                          help="spans per source chunk (replay, synthetic)")
    p_stream.add_argument("--rate", type=float, default=None,
                          help="replay at this multiple of event time (overrides "
                          "--pace-seconds)")
    p_stream.add_argument("--poll-seconds", type=float, default=2.0,
                          help="--source tail: seconds between polls")
    p_stream.add_argument("--idle-exit", type=_positive_int, default=None,
                          help="--source tail: stop after this many polls without progress "
                          "(default: tail forever)")
    p_stream.add_argument("--windows", type=_positive_int, default=8,
                          help="--source synthetic: timeline windows")
    p_stream.add_argument("--fault-windows", default="3",
                          help="--source synthetic: comma-separated faulted window indices "
                          "(empty: none)")
    p_stream.add_argument("--operations", type=int, default=30)
    p_stream.add_argument("--pods", type=int, default=1)
    p_stream.add_argument("--kinds", type=int, default=24)
    p_stream.add_argument("--traces", type=int, default=300)
    p_stream.add_argument("--fault-ms", type=float, default=2000.0)
    p_stream.add_argument("--fault-kind", choices=["latency", "error"], default="latency",
                          help="latency faults only: error is not ported (item 11)")
    p_stream.add_argument("--fault-count", type=_positive_int, default=1,
                          help="--source synthetic: injected culprits")
    p_stream.add_argument("--drift", type=float, default=0.0,
                          help="not ported: the drift family (item 11); must stay 0")
    p_stream.add_argument("--seed", type=int, default=0)
    p_stream.add_argument("--metrics-port", type=int, default=None,
                          help="serve live telemetry over HTTP on this port (127.0.0.1); the "
                          "snapshot also lands in -o at exit")
    p_stream.add_argument("--fleet", type=_positive_int, default=None, metavar="N",
                          help="not ported: the fleet (item 11)")
    p_stream.add_argument("--fleet-role", choices=["worker"], default=None,
                          help="not ported: the fleet (item 11)")
    p_stream.add_argument("--warehouse", action="store_true",
                          help="seal every closed window into a tiered trace warehouse under "
                          "the output dir (warm segment per window with its rank blob, cold "
                          "compaction); enables `replay --at` and `scenarios --from-warehouse`")
    p_stream.add_argument("--warehouse-dir", default=None, metavar="DIR",
                          help="warehouse directory (default: <output>/warehouse; implies "
                          "--warehouse)")
    p_stream.add_argument("--delta-build", action="store_true",
                          help="not ported: the incremental sliding-window build")
    p_stream.add_argument("--warm-start", action="store_true",
                          help="warm-start each ranked window's iteration from the previous "
                          "window's converged state while an incident is open (K19; pays off "
                          "with a convergence tol)")
    p_stream.add_argument("--fused-pair", action="store_true",
                          help="fused pair program: each abnormal window and its warm init "
                          "staged as one blob, both solves and the epilogue in one program, "
                          "its state exported to warm-start the next window")
    _add_config_flags(p_stream)
    p_stream.set_defaults(fn=cmd_stream)

    p_srv = sub.add_parser(
        "serve", help="online RCA service: HTTP requests coalesced into stacked rank "
        "programs on the card, with admission control and the numpy_ref oracle when a "
        "dispatch fails")
    p_srv.add_argument("--normal", required=True,
                       help="normal-period traces.csv (SLO baseline fitted at startup)")
    p_srv.add_argument("--dataset", action="append", metavar="NAME=CSV",
                       help="pre-stage an abnormal dump; requests may then send "
                       '{"dataset": NAME, "start": ..., "end": ...} instead of inline spans '
                       "(repeatable)")
    p_srv.add_argument("--host", default=None, help="bind address")
    p_srv.add_argument("--port", type=int, default=None,
                       help="listen port (0 picks a free port; default 8377)")
    p_srv.add_argument("-o", "--output", default=None,
                       help="service output directory: journal.jsonl per batch and window, "
                       "flight dumps, and the metrics snapshot written at drain")
    p_srv.add_argument("--max-queue-depth", type=_positive_int, default=None,
                       help="admission bound: requests admitted at once before the service "
                       "answers 429 with a Retry-After")
    p_srv.add_argument("--retry-after", type=float, default=None,
                       help="Retry-After seconds on 429/503 responses (the floor of the "
                       "measured price)")
    p_srv.add_argument("--max-batch-windows", type=_positive_int, default=None,
                       help="micro-batch ceiling: a shape bucket dispatches as soon as it "
                       "holds this many requests")
    p_srv.add_argument("--max-wait-ms", type=float, default=None,
                       help="micro-batch latency bound: a bucket dispatches once its oldest "
                       "request waited this long")
    p_srv.add_argument("--request-timeout", type=float, default=None,
                       help="seconds an HTTP caller waits before 504")
    p_srv.add_argument("--drain-seconds", type=float, default=None,
                       help="SIGTERM drain bound for in-flight requests")
    p_srv.add_argument("--no-warmup", action="store_true",
                       help="skip the startup warmup dispatches")
    p_srv.add_argument("--warmup-occupancies", default=None, metavar="N,N,...",
                       help='batch occupancies the startup warmup dispatches (default "1,2"); '
                       "every entry must be <= --max-batch-windows")
    p_srv.add_argument("--build-workers", type=int, default=None,
                       help="build-pool threads running the host half off the scheduler "
                       "thread (0 = on the scheduler thread)")
    p_srv.add_argument("--no-fallback", action="store_true",
                       help="disable the numpy_ref degradation: failed batches answer 500 "
                       "(always so on the card)")
    p_srv.add_argument("--mesh", default=None, help="not ported: the sharded route (item 12)")
    p_srv.add_argument("--inject-dispatch-failures", type=int, default=None,
                       help="test knob: fail this many device dispatches with an injected "
                       "error (drives the degradation path)")
    p_srv.add_argument("--stream-input", default=None, metavar="TRACES_CSV",
                       help="co-deploy: tail this growing trace file through a stream engine "
                       "sharing the card through the device scheduler; open-incident work "
                       "preempts serve requests")
    p_srv.add_argument("--backfill", default=None, metavar="WAREHOUSE_DIR",
                       help="co-deploy: replay this trace warehouse on the device scheduler's "
                       "backfill lane (behind serve and stream) while the service answers; "
                       "the report lands in OUT/backfill.json")
    p_srv.add_argument("--backfill-range", default=None, metavar="START..END",
                       help="the stored range --backfill replays (default: all)")
    p_srv.add_argument("--tenant-weight", action="append", metavar="NAME=W",
                       help="weighted fair share: tenant NAME gets W times the turns of a "
                       "weight-1 tenant (repeatable)")
    p_srv.add_argument("--tenant-rate", action="append", metavar="NAME=R",
                       help="soft token-bucket quota: tenant NAME refills R windows/s (0 = "
                       "background: runs only when in-quota tenants are idle; unlisted "
                       "tenants are unlimited) (repeatable)")
    _add_config_flags(p_srv)
    p_srv.set_defaults(fn=cmd_serve)

    p_exp = sub.add_parser(
        "explain", help="render rank provenance from run artifacts (explain bundles, journal "
        "explain events, flight-dump bundles)")
    p_exp.add_argument("target", help="an explain bundle .json, a run output dir (reads "
                       "explain/*/ bundles or journal.jsonl), a flight dump dir (reads its "
                       "bundle), or a journal.jsonl path")
    p_exp.add_argument("--window", default=None, help="select the bundle for this window start "
                       "(default: the latest bundle found)")
    p_exp.add_argument("--format", choices=["table", "json"], default="table",
                       help="human-readable table (default) or the raw bundle JSON")
    p_exp.add_argument("--json", default=None, help="also write the selected bundle JSON to "
                       "this path")
    p_exp.set_defaults(fn=cmd_explain)

    p_scn = sub.add_parser(
        "scenarios", help="score all 13 spectrum formulas and persist the selected policy; "
        "--from-warehouse scores a stored run's incidents (the synthetic matrix is not ported)")
    p_scn.add_argument("-o", "--output", default="scenario_out",
                       help="artifact directory of the synthetic matrix (not ported)")
    p_scn.add_argument("--seed", type=int, default=0, help="recorded as the policy's seed")
    p_scn.add_argument("--no-persist-policy", action="store_true",
                       help="emit the artifact but do not write policy.json")
    p_scn.add_argument("--json", default=None, help="also write the full artifact JSON here")
    p_scn.add_argument("--from-warehouse", default=None, metavar="DIR",
                       help="retroactive lane: score a stored run's warehouse incidents "
                       "across all 13 formulas (tie-aware MAP/MRR/top-k against the "
                       "recorded truth) and persist the winning policy")
    _add_config_flags(p_scn)
    p_scn.set_defaults(fn=cmd_scenarios)

    p_replay = sub.add_parser(
        "replay", help="time-travel RCA: re-rank stored warehouse windows for a time range "
        "from their blobs and verify tie-aware agreement with the stored verdicts; exits "
        "nonzero on a mismatch")
    p_replay.add_argument("target", help="a stream run output dir (reads its warehouse/) or a "
                          "warehouse directory itself")
    p_replay.add_argument("--at", required=True, metavar="RANGE",
                          help="'all', 'START..END' (each side an epoch-microsecond integer "
                          "or a date / date-time, either side empty = open), or one instant "
                          "selecting the window(s) holding it")
    p_replay.add_argument("-k", "--top", type=int, default=5,
                          help="verify agreement over the top-k of each stored verdict "
                          "(default 5)")
    p_replay.add_argument("--json", default=None,
                          help="also write the full replay report JSON to this path")
    _add_config_flags(p_replay)
    p_replay.set_defaults(fn=cmd_replay)

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
