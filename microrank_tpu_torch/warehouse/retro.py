"""Retroactive scenario scoring over stored incidents (counterpart of
``microrank_tpu/warehouse/retro.py``).

``cli scenarios --from-warehouse DIR`` treats a warehouse as a scenario
source: every stored ranked window is ranked again under all 13
spectrum formulas in one program (K13, ``blob.stage_rank_window(...,
all_methods=True)`` over the stored blob: one launch of the epilogue a
window), its spectrum widened so every op gets an exact rank; each
formula is scored tie-aware (MAP, MRR, top-k) against the run's
recorded truth, aggregated in the scenario harness's ``formulas`` shape
and fed to ``select_policy``: the policy engine tunes on real incident
outcomes. Truth comes from the manifest (the engine records the fault
source's pod:ops when it has them); without it, the consensus live
top-1 across the stored incidents stands in (``outcome_source ==
"incident_top1"``).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional

RETRO_MATRIX_NAME = "retro_matrix.json"

_KS = (1, 2, 3, 5)


def run_retro(path, config=None, seed: Optional[int] = None, persist_policy: bool = True,
              name: Optional[str] = None, out_path=None) -> dict:
    """Score a warehouse's stored incidents under every formula.

    Returns ``{"record": <harness-shaped record>, "policy": <selected
    policy document>, "truth", "outcome_source", ...}`` and writes
    ``retro_matrix.json`` into the warehouse dir (or ``out_path``)."""
    import numpy as np

    from ..config import MicroRankConfig
    from ..evaluation import ranking_metrics
    from ..rank_backends.blob import stage_rank_window
    from ..rank_backends.torch_cuda import pack_rank_outputs, unpack_rank_outputs
    from ..scenarios.policy import (
        profile_from_counts,
        resolve_policy_dir,
        save_policy,
        select_policy,
    )
    from ..spectrum.formulas import METHODS
    from ..utils.atomic import atomic_write_json
    from ..utils.device import resolve_device
    from ..utils.guards import claim_device_owner
    from .store import TraceWarehouse, resolve_warehouse_dir

    if config is None:
        config = MicroRankConfig()
    claim_device_owner("warehouse-retro")
    device = resolve_device(config.runtime.device)
    whdir = resolve_warehouse_dir(path)
    store = TraceWarehouse(whdir, config.warehouse)
    windows = store.query()
    ranked = [w for w in windows if w.outcome == "ranked" and w.ranking]
    truth, outcome_source = _resolve_truth(store, ranked)

    per_method: Dict[str, List[dict]] = {m: [] for m in METHODS}
    scored_windows = 0
    spans_total = 0
    dedup_vals = []
    vocab_sizes = []
    for w in ranked:
        g = w.graph()
        op_names = w.op_names
        if g is None or not op_names or not truth:
            continue
        # Full depth: every op gets an exact rank (JAX's widening,
        # anchored to the stored blob's own op table).
        widened = dataclasses.replace(config.spectrum, top_max=len(op_names))
        outs, staged = stage_rank_window(g, config.pagerank, widened, w.kernel or "coo", device,
                                         config.runtime.blob_staging, all_methods=True)
        top_idx, top_scores, n_valid = unpack_rank_outputs(pack_rank_outputs(outs, staged))
        n = int(n_valid)
        for mi, m in enumerate(METHODS):
            names = [op_names[int(i)] for i in top_idx[mi, :n]]
            scores = [float(s) for s in top_scores[mi, :n]]
            per_method[m].append(ranking_metrics(names, scores, truth, ks=_KS))
        scored_windows += 1
        spans_total += int(w.meta.get("spans", 0))
        if w.meta.get("kind_dedup"):
            dedup_vals.append(float(w.meta["kind_dedup"]))
        vocab = w.vocab_names
        vocab_sizes.append(len(vocab) if vocab else len(op_names))

    formulas = _aggregate(per_method, truth)
    profile = None
    if scored_windows:
        profile = profile_from_counts(
            n_spans=int(spans_total / scored_windows), n_ops=int(np.mean(vocab_sizes)),
            dedup_factor=float(np.mean(dedup_vals)) if dedup_vals else None).key()
    run_name = name or Path(whdir).resolve().parent.name or "run"
    record = {
        "scenario": f"warehouse:{run_name}",
        "family": "warehouse",
        "seed": seed,
        "profile": profile,
        "spans": int(spans_total),
        "truth": list(truth),
        "outcome_source": outcome_source,
        "windows": scored_windows,
        "formulas": formulas,
    }
    policy = select_policy([record], None, matrix_seed=seed)
    policy_path = None
    if persist_policy and formulas and profile:
        policy_path = str(save_policy(resolve_policy_dir(), policy))
    result = {
        "record": record,
        "policy": policy,
        "policy_path": policy_path,
        "truth": list(truth),
        "outcome_source": outcome_source,
        "windows_stored": len(windows),
        "windows_ranked": len(ranked),
        "windows_scored": scored_windows,
    }
    artifact = Path(out_path) if out_path else whdir / RETRO_MATRIX_NAME
    atomic_write_json(artifact, result)
    result["artifact"] = str(artifact)
    return result


def _resolve_truth(store, ranked):
    """The manifest's truth, else the consensus live top-1 across the
    stored incidents (self-referential, flagged by ``outcome_source``)."""
    truth = store.truth
    if truth:
        if isinstance(truth, dict):
            truth = sorted({str(v) for vals in truth.values()
                            for v in (vals if isinstance(vals, list) else [vals])})
        return [str(t) for t in truth], "manifest"
    counts: Dict[str, int] = {}
    for w in ranked:
        if w.ranking:
            top1 = w.ranking[0][0]
            counts[top1] = counts.get(top1, 0) + 1
    if not counts:
        return [], "none"
    best = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))[0][0]
    return [best], "incident_top1"


def _aggregate(per_method: Dict[str, List[dict]], truth) -> Dict[str, dict]:
    """The scenario harness's ``formulas`` aggregation (its shape, so a
    retro record is ``select_policy`` input)."""
    formulas: Dict[str, dict] = {}
    for m, rows in per_method.items():
        if not rows:
            continue
        n = len(rows)

        def mean(vals, n=n):
            return sum(vals) / n

        topk_rate = {int(k): mean([float(r["topk_exact"][int(k)]) for r in rows]) for k in _KS}
        found = [r2 for r in rows for r2 in r["ranks"].values() if r2 is not None]
        formulas[m] = {
            "map": round(mean([r["ap"] for r in rows]), 4),
            "mrr": round(mean([r["rr"] for r in rows]), 4),
            "top1_rate": round(topk_rate.get(1, 0.0), 4),
            "topc_rate": round(mean([float(all(r3 is not None and r3 <= max(1, len(truth))
                                               for r3 in r["ranks"].values()))
                                     for r in rows]), 4),
            "topk_rate": topk_rate,
            "mean_rank": round(sum(found) / len(found), 2) if found else None,
            "unranked": sum(1 for r in rows for r2 in r["ranks"].values() if r2 is None),
            "windows": n,
        }
    return formulas


def render_retro_table(result: dict) -> str:
    """A small fixed-width table of the formulas (JAX's)."""
    formulas = (result.get("record") or {}).get("formulas") or {}
    lines = [f"warehouse retro-score: {result.get('windows_scored', 0)} windows, "
             f"truth={result.get('truth')} ({result.get('outcome_source')})"]
    if not formulas:
        lines.append("  (no scored windows)")
        return "\n".join(lines)
    lines.append(f"  {'formula':<16} {'MAP':>7} {'MRR':>7} {'top1':>6} {'top3':>6} "
                 f"{'top5':>6} {'meanrk':>7}")
    for m in sorted(formulas, key=lambda m: -float(formulas[m]["map"] or 0)):
        row = formulas[m]
        tk = row.get("topk_rate") or {}
        mr = row.get("mean_rank")
        lines.append(f"  {m:<16} {row['map']:>7.4f} {row['mrr']:>7.4f} {tk.get(1, 0):>6.2f} "
                     f"{tk.get(3, 0):>6.2f} {tk.get(5, 0):>6.2f} "
                     f"{mr if mr is not None else '-':>7}")
    for prof, entry in ((result.get("policy") or {}).get("profiles") or {}).items():
        lines.append(f"  policy: {prof} -> method={entry['method']} "
                     f"(MAP {entry['evidence']['map']})")
    return "\n".join(lines)
