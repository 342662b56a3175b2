"""Host materialization of rank provenance: the ExplainBundle
(counterpart of ``microrank_tpu/explain/bundle.py``).

The explained program (K15, ``rank_backends.torch_cuda.
rank_window_explained``) returns raw attribution tensors over padded
vocab and column indices; ``build_bundle`` joins them with the build's
op names and its coverage-column retention map (``ExplainContext``)
into a self-contained record:

* JSON (``explain_bundle.json``), machine-readable, schema-versioned;
* a table (``explain_bundle.txt``), what an operator reads next to an
  incident (``cli explain`` prints it).

A bundle names, per suspect: rank and score, the ef/nf/ep/np counters,
the normal/abnormal PageRank mass, the score every spectrum formula
would give, and the top contributing traces per partition (trace id,
contribution ``p_sr[v, t] * rv[t]``, and the column's multiplicity on
kind-collapsed builds). The warm start's trace axis maps by the same
``ExplainContext`` (``rank_backends.warm.map_warm_state``).
"""

from __future__ import annotations

import json
import math
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ..spectrum.formulas import METHODS

BUNDLE_SCHEMA = 1
BUNDLE_JSON = "explain_bundle.json"
BUNDLE_TXT = "explain_bundle.txt"

COUNTER_NAMES = ("ef", "nf", "ep", "np")


@dataclass
class ExplainContext:
    """Build-side retention the device outputs are joined against:
    per partition, coverage column -> (representative) trace id and the
    column's multiplicity (1 on uncollapsed builds)."""

    normal_trace_ids: List
    abnormal_trace_ids: List
    normal_mult: List[int]
    abnormal_mult: List[int]

    @classmethod
    def from_build(cls, graph, ids_n, ids_a, map_n, map_a):
        """Join the build's trace-id lists with its column retention map
        (None: identity, every column is one trace)."""

        def one(part, ids, cmap):
            n_cols = int(np.asarray(part.n_cols))
            if n_cols < 0 or cmap is None:
                return list(ids), [1] * len(ids)
            col_ids = [ids[int(i)] for i in np.asarray(cmap)[:n_cols]]
            mult = [int(m) for m in np.asarray(part.kind)[:n_cols]]
            return col_ids, mult

        cn, mn = one(graph.normal, ids_n, map_n)
        ca, ma = one(graph.abnormal, ids_a, map_a)
        return cls(normal_trace_ids=cn, abnormal_trace_ids=ca, normal_mult=mn,
                   abnormal_mult=ma)

    def columns(self, partition: int) -> Tuple[List, List[int]]:
        if partition == 0:
            return self.normal_trace_ids, self.normal_mult
        return self.abnormal_trace_ids, self.abnormal_mult


def build_bundle(
    outs,
    op_names: List[str],
    ectx: Optional[ExplainContext],
    method: str,
    kernel: str = "",
    window: Optional[dict] = None,
    trigger: str = "on_demand",
) -> "ExplainBundle":
    """Join one fetched explained-program output tuple (host arrays,
    ``rank_window_explained``'s ten) with the build context into an
    ExplainBundle. ``ectx=None``: contributing columns are reported by
    column index instead of trace id."""
    (
        top_idx, top_scores, n_valid, _residuals, n_iters,
        counters, terms, mass, trace_idx, trace_val,
    ) = (np.asarray(o) for o in outs[:10])
    n = min(int(n_valid), counters.shape[1])
    suspects = []
    for i in range(n):
        vi = int(top_idx[i])
        traces = {}
        for p, pname in enumerate(("normal", "abnormal")):
            cols, mult = ectx.columns(p) if ectx is not None else (None, None)
            entries = []
            for j in range(trace_idx.shape[2]):
                val = float(trace_val[p, i, j])
                if not math.isfinite(val) or val <= 0.0:
                    continue
                ci = int(trace_idx[p, i, j])
                entry = {"column": ci, "contribution": val}
                if cols is not None and ci < len(cols):
                    entry["trace"] = str(cols[ci])
                    entry["multiplicity"] = int(mult[ci])
                entries.append(entry)
            traces[pname] = entries
        suspects.append({
            "rank": i + 1,
            "op": op_names[vi] if vi < len(op_names) else str(vi),
            "score": float(top_scores[i]),
            "counters": {cn: float(counters[c, i]) for c, cn in enumerate(COUNTER_NAMES)},
            "mass": {"normal_weight": float(mass[0, i]), "abnormal_weight": float(mass[1, i])},
            "terms": {m: float(terms[mi, i]) for mi, m in enumerate(METHODS)},
            "top_traces": traces,
        })
    data = {
        "schema": BUNDLE_SCHEMA,
        "generated_ts": time.time(),
        "trigger": trigger,
        "method": method,
        "kernel": kernel,
        "iterations": int(n_iters),
        "window": dict(window or {}),
        "suspects": suspects,
    }
    return ExplainBundle(data)


@dataclass
class ExplainBundle:
    """One window's rank provenance, serializable both ways."""

    data: dict

    @property
    def suspects(self) -> List[dict]:
        return self.data.get("suspects", [])

    @property
    def window(self) -> dict:
        return self.data.get("window", {})

    def top1(self) -> Optional[str]:
        s = self.suspects
        return s[0]["op"] if s else None

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.data, indent=indent)

    def to_table(self) -> str:
        """The human-readable rendering (the .txt artifact, ``cli
        explain``), JAX's lines."""
        d = self.data
        lines = [
            "Rank provenance — window "
            f"{d.get('window', {}).get('start', '?')} "
            f"(kernel={d.get('kernel') or '?'}, "
            f"method={d.get('method')}, "
            f"iterations={d.get('iterations')})",
        ]
        for s in self.suspects:
            c = s["counters"]
            m = s["mass"]
            lines.append(f"  #{s['rank']} {s['op']}  score={s['score']:.6g}")
            lines.append(
                f"      counters ef={c['ef']:.6g} nf={c['nf']:.6g} "
                f"ep={c['ep']:.6g} np={c['np']:.6g}   "
                f"mass normal={m['normal_weight']:.6g} "
                f"abnormal={m['abnormal_weight']:.6g}"
            )
            ranked_terms = sorted(s["terms"].items(), key=lambda kv: -kv[1])
            lines.append(
                "      formulas "
                + " ".join(f"{k}={v:.4g}" for k, v in ranked_terms[:5])
                + (" ..." if len(ranked_terms) > 5 else "")
            )
            for pname in ("abnormal", "normal"):
                entries = s["top_traces"].get(pname, [])
                if not entries:
                    continue
                lines.append(
                    f"      {pname} traces "
                    + " ".join(
                        f"{e.get('trace', e['column'])}"
                        + (f"(x{e['multiplicity']})" if e.get("multiplicity", 1) != 1 else "")
                        + f"={e['contribution']:.4g}"
                        for e in entries
                    )
                )
        return "\n".join(lines) + "\n"

    def journal_record(self) -> dict:
        """The compact record of the run journal's ``explain`` event."""
        s0 = self.suspects[0] if self.suspects else None
        return {
            "start": self.window.get("start"),
            "end": self.window.get("end"),
            "kernel": self.data.get("kernel"),
            "trigger": self.data.get("trigger"),
            "suspects": len(self.suspects),
            "top1": s0["op"] if s0 else None,
            "ef_top1": s0["counters"]["ef"] if s0 else None,
        }

    def write(self, dest) -> Path:
        """Write the JSON and the table under the directory ``dest``;
        returns the JSON's path. Each file atomically (tmp, fsync,
        rename): ``cli explain`` reads them back, and a kill mid-write
        leaves no bundle or a whole one."""
        from ..utils.atomic import atomic_write_text

        dest = Path(dest)
        dest.mkdir(parents=True, exist_ok=True)
        path = atomic_write_text(dest / BUNDLE_JSON, self.to_json())
        atomic_write_text(dest / BUNDLE_TXT, self.to_table())
        return path

    @classmethod
    def load(cls, path) -> "ExplainBundle":
        return cls(json.loads(Path(path).read_text()))
