"""Command line of the port (counterpart of the native branch of
``microrank_tpu/cli/main.py`` ``cmd_run``, plus ``synth``).

    python -m microrank_tpu_torch.cli run --normal N --abnormal A -o OUT [--device cuda|cpu]
    python -m microrank_tpu_torch.cli synth -o DIR [--operations 40 ...]

``run`` ranks every anomalous window of the abnormal dump and writes
``OUT/result.csv`` and ``OUT/windows.jsonl`` in the JAX package's
format. It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from pathlib import Path
from typing import List, Optional

from .config import MicroRankConfig, RuntimeConfig

log = logging.getLogger("microrank_tpu_torch.cli")


def _config_from_args(args) -> MicroRankConfig:
    return MicroRankConfig(
        runtime=RuntimeConfig(collapse_kinds=args.collapse_kinds, device=args.device)
    )


def cmd_run(args) -> int:
    from .pipeline import run_rca_native

    cfg = _config_from_args(args)
    results = run_rca_native(args.normal, args.abnormal, cfg, out_dir=args.output)
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
