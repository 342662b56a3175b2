"""Float64 numpy oracle for rank provenance (counterpart of
``microrank_tpu/explain/oracle.py``).

Recomputes, over the UNCOLLAPSED padded COO window graph and entirely in
float64 ``np.bincount`` arithmetic (``rank_backends.sparse_oracle``'s
summation structure, independent of every device kernel's):

* each suspect's spectrum counters ef/nf/ep/np and its term under every
  one of the 13 formulas;
* the normal/abnormal PageRank weight split;
* the per-trace coverage contributions ``p_sr[v, t] * rv[t]`` at
  convergence, optionally summed per trace kind (what a kind-collapsed
  build's columns report, each column standing for its kind with the
  multiplicity folded into p_sr).

The tests and ``chip_smoke.py`` hold the explained program's bundle to
it, tie-aware.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import PageRankConfig, SpectrumConfig
from ..rank_backends.sparse_oracle import (
    _iterate_sparse,
    _partition_arrays,
    _preference,
    recompute_kinds,
    spectrum_score,
)
from ..spectrum.formulas import METHODS


def _kind_groups(inc_trace, inc_op, tracelen, n_traces: int):
    """(group_of[t], representative[g]): kind groups by byte signature
    (recompute_kinds' equivalence), each group's representative its
    LOWEST trace index (the collapse build's retention-map choice)."""
    order = np.lexsort((inc_op, inc_trace))
    tr = np.asarray(inc_trace)[order]
    op = np.asarray(inc_op)[order]
    starts = np.searchsorted(tr, np.arange(n_traces), side="left")
    ends = np.searchsorted(tr, np.arange(n_traces), side="right")
    sigs: Dict = {}
    group_of = np.zeros(n_traces, dtype=np.int64)
    reps: List[int] = []
    for t in range(n_traces):
        key = (op[starts[t]:ends[t]].tobytes(), float(tracelen[t]))
        g = sigs.setdefault(key, len(sigs))
        group_of[t] = g
        if g == len(reps):
            reps.append(t)
    return group_of, np.asarray(reps, dtype=np.int64)


def _partition_explain(g, anomaly: bool, cfg: PageRankConfig):
    """One partition's f64 (weight[v_pad], trace_num[v_pad], rv[T],
    arrays)."""
    p = _partition_arrays(g)
    v_pad = g.op_present.shape[0]
    kinds = recompute_kinds(p["inc_trace"], p["inc_op"], p["tracelen"], p["n_traces"])
    pref = _preference(kinds, p["tracelen"], anomaly, cfg)
    v_s, v_r = _iterate_sparse(p, pref, v_pad, cfg)
    total = float(v_s[p["op_present"]].sum())
    weight = np.where(p["op_present"], v_s * total / p["n_ops"], 0.0)
    trace_num = np.bincount(p["inc_op"], minlength=v_pad).astype(np.int64)
    return weight, trace_num, np.asarray(v_r, dtype=np.float64), p


def _contributions(p: dict, rv: np.ndarray, vocab_idx: int, trace_ids: List,
                   groups) -> List[Tuple[str, float]]:
    """[(trace_id, contribution)] of one suspect, descending, ties by
    ascending column: per trace, or with ``groups`` (``_kind_groups`` of
    the partition) summed per kind under the group representative's id
    (the collapsed build's view)."""
    sel = p["inc_op"] == vocab_idx
    tr = p["inc_trace"][sel]
    contrib = p["sr_val"][sel] * rv[tr]
    per_trace = np.zeros(p["n_traces"], dtype=np.float64)
    per_trace[tr] = contrib
    if groups is not None:
        group_of, reps = groups
        vals = np.zeros(len(reps), dtype=np.float64)
        np.add.at(vals, group_of, per_trace)
        ids = [trace_ids[int(r)] for r in reps]
    else:
        ids = list(trace_ids[: p["n_traces"]])
        vals = per_trace
    order = sorted(range(len(ids)), key=lambda i: (-vals[i], i))
    return [(str(ids[i]), float(vals[i])) for i in order if vals[i] > 0.0]


def explain_window_oracle(
    graph,
    op_names: List[str],
    normal_trace_ids: List,
    abnormal_trace_ids: List,
    pagerank_cfg: PageRankConfig = PageRankConfig(),
    spectrum_cfg: SpectrumConfig = SpectrumConfig(),
    top_traces: Optional[int] = None,
    aggregate_kinds: bool = False,
) -> dict:
    """The f64 provenance of one UNCOLLAPSED host window graph:
    ``{"suspects": [...]}`` shaped like an ExplainBundle's suspect list
    (rank, op, score, counters, terms, mass, and ``top_traces`` per
    partition: every positive contributor when ``top_traces`` is None,
    for a tie-aware comparison that cuts where the caller's list
    does)."""
    n_weight, n_num, rv_n, n_p = _partition_explain(graph.normal, False, pagerank_cfg)
    a_weight, a_num, rv_a, a_p = _partition_explain(graph.abnormal, True, pagerank_cfg)
    in_a = np.asarray(graph.abnormal.op_present)
    in_n = np.asarray(graph.normal.op_present)
    eps = spectrum_cfg.eps
    cells: Dict[int, Dict[str, float]] = {}
    for vi in np.flatnonzero(in_a | in_n):
        cell: Dict[str, float] = {}
        if in_a[vi]:
            a = a_weight[vi]
            cell["ef"] = a * a_num[vi]
            cell["nf"] = a * (a_p["n_traces"] - a_num[vi])
            if in_n[vi]:
                nw = n_weight[vi]
                cell["ep"] = nw * n_num[vi]
                cell["np"] = nw * (n_p["n_traces"] - n_num[vi])
            else:
                cell["ep"] = eps
                cell["np"] = eps
        else:
            nw = n_weight[vi]
            cell["ef"] = eps
            cell["nf"] = eps
            cell["ep"] = (1 + nw) * n_num[vi]
            cell["np"] = n_p["n_traces"] - n_num[vi]
        cells[int(vi)] = cell
    scored = {vi: spectrum_score(cell, spectrum_cfg.method) for vi, cell in cells.items()}
    ranked = sorted(scored.items(), key=lambda x: (-x[1], op_names[x[0]]))
    top = ranked[: spectrum_cfg.n_rows]
    # Each partition's kind groups, once (JAX's twin regroups per suspect).
    groups_n = groups_a = None
    if aggregate_kinds:
        groups_n = _kind_groups(n_p["inc_trace"], n_p["inc_op"],
                                np.asarray(graph.normal.tracelen), n_p["n_traces"])
        groups_a = _kind_groups(a_p["inc_trace"], a_p["inc_op"],
                                np.asarray(graph.abnormal.tracelen), a_p["n_traces"])
    suspects = []
    for rank, (vi, score) in enumerate(top, 1):
        cell = cells[vi]
        tr_n = _contributions(n_p, rv_n, vi, normal_trace_ids, groups_n)
        tr_a = _contributions(a_p, rv_a, vi, abnormal_trace_ids, groups_a)
        if top_traces is not None:
            tr_n = tr_n[:top_traces]
            tr_a = tr_a[:top_traces]
        suspects.append({
            "rank": rank,
            "op": op_names[vi],
            "score": float(score),
            "counters": {k: float(cell[k]) for k in cell},
            "mass": {"normal_weight": float(n_weight[vi]),
                     "abnormal_weight": float(a_weight[vi])},
            "terms": {m: float(spectrum_score(cell, m)) for m in METHODS},
            "top_traces": {"normal": tr_n, "abnormal": tr_a},
        })
    return {"suspects": suspects}
