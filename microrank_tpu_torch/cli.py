"""Command line of the port (counterpart of the native branch of
``microrank_tpu/cli/main.py`` ``cmd_run``, plus ``synth``).

    python -m microrank_tpu_torch.cli run --normal N --abnormal A -o OUT [--device cuda|cpu]
        [--kernel auto|kind|packed|packed_bf16|packed_blocked|pcsr|pallas]
        [--kind-precision f32|bf16] [--pipeline-depth N] [--sync-dispatch]
        [--fetch-mode stream|bulk] [--bulk-fetch-windows N] [--resume]
    python -m microrank_tpu_torch.cli synth -o DIR [--operations 40 ...]

``run`` ranks every anomalous window of the abnormal dump and writes
``OUT/result.csv`` and ``OUT/windows.jsonl`` in the JAX package's
format, with the window cursor and the run journal beside them. It runs
on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from pathlib import Path
from typing import List, Optional

from .config import (
    FETCH_MODES,
    KERNELS,
    KIND_PRECISIONS,
    MicroRankConfig,
    PageRankConfig,
    RuntimeConfig,
)

log = logging.getLogger("microrank_tpu_torch.cli")


def _positive_int(text: str) -> int:
    value = int(text)
    if value < 1:
        raise argparse.ArgumentTypeError(f"expected a positive integer, got {text}")
    return value


def _config_from_args(args) -> MicroRankConfig:
    # The loop's knobs override the config only where given, as in the
    # JAX CLI.
    loop = {
        k: v for k, v in (
            ("pipeline_depth", args.pipeline_depth),
            ("fetch_mode", args.fetch_mode),
            ("bulk_fetch_windows", args.bulk_fetch_windows),
        ) if v is not None
    }
    if args.sync_dispatch:
        loop["async_dispatch"] = False
    return MicroRankConfig(
        pagerank=PageRankConfig(kind_precision=args.kind_precision),
        runtime=RuntimeConfig(
            kernel=args.kernel, collapse_kinds=args.collapse_kinds,
            device=args.device, **loop,
        ),
    )


def cmd_run(args) -> int:
    from .pipeline import run_rca_native

    cfg = _config_from_args(args)
    if args.bulk_fetch_windows is not None and cfg.runtime.fetch_mode != "bulk":
        log.warning("--bulk-fetch-windows has no effect without --fetch-mode bulk")
    results = run_rca_native(
        args.normal, args.abnormal, cfg, out_dir=args.output, resume=args.resume
    )
    ranked = [r for r in results if r.ranking]
    log.info(
        "%d windows, %d ranked; results in %s", len(results), len(ranked),
        args.output,
    )
    for r in ranked:
        top = r.ranking[0]
        print(f"{r.start}: top-1 {top[0]} ({top[1]:.6g})")
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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m microrank_tpu_torch.cli")
    sub = p.add_subparsers(dest="cmd", required=True)

    p_run = sub.add_parser("run", help="RCA over a normal / abnormal trace dump pair")
    p_run.add_argument("--normal", required=True, help="normal-period traces.csv")
    p_run.add_argument("--abnormal", required=True, help="traces.csv to analyze")
    p_run.add_argument("-o", "--output", default="rca_out")
    p_run.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p_run.add_argument(
        "--collapse-kinds", default="auto", choices=["auto", "on", "off"]
    )
    p_run.add_argument(
        "--kernel", default="auto", choices=list(KERNELS),
        help="power-iteration kernel ('auto': 'kind' when the measured "
        "kind dedup factor clears the threshold, else 'packed_bf16'; past "
        "the dense budget 'packed_blocked', then 'pcsr')",
    )
    p_run.add_argument(
        "--kind-precision", default="f32", choices=list(KIND_PRECISIONS),
        help="kernel='kind' coverage matvec precision: f32, or bf16 "
        "operands with f32 accumulation",
    )
    p_run.add_argument(
        "--resume", action="store_true", help="resume from the window cursor"
    )
    p_run.add_argument(
        "--sync-dispatch", action="store_true",
        help="disable the async stage/fetch worker threads (default on: "
        "the dispatch and the result wait overlap the next window's host "
        "work)",
    )
    p_run.add_argument(
        "--pipeline-depth", type=_positive_int, default=None,
        help="device rank programs allowed in flight (1 = synchronous)",
    )
    p_run.add_argument(
        "--fetch-mode", choices=list(FETCH_MODES), default=None,
        help="result joins: per window ('stream', lowest sink latency) or "
        "over --bulk-fetch-windows windows at once ('bulk'; supersedes "
        "--pipeline-depth as the in-flight bound)",
    )
    p_run.add_argument(
        "--bulk-fetch-windows", type=_positive_int, default=None,
        help="windows joined at once in --fetch-mode bulk",
    )
    p_run.set_defaults(fn=cmd_run)

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
