"""Sparse float64 numpy oracle (counterpart of
``microrank_tpu/rank_backends/sparse_oracle.py``): the independent
reference for windows too large to rank on the CPU through the port.

It derives the same ranking as the device path — preference vector
(reference pagerank.py:68-85), power iteration (pagerank.py:116-130),
rescale and coverage counts (pagerank.py:93-112), the weighted spectrum
(online_rca.py:33-152) — from the padded COO window graph, with float64
vectors and ``np.bincount`` segment sums instead of the kernels. Memory
is O(E + V + T).

Independence from the device path: everything after the COO entries is
computed here in another summation structure and in float64, with the
trace kinds grouped again by a byte signature (the build groups them by
hash) and the coverage counts counted again from the entries. The COO
entries themselves are shared with the device path.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

from ..config import PageRankConfig, SpectrumConfig


def spectrum_score(cell: Dict[str, float], method: str) -> float:
    """The 13 spectrum formulas (online_rca.py:75-142), scalar form (the
    JAX package's ``numpy_ref.spectrum_score``)."""
    ef, nf = cell["ef"], cell["nf"]
    ep, np_ = cell["ep"], cell["np"]
    if method == "dstar2":
        return ef * ef / (ep + nf)
    if method == "ochiai":
        return ef / math.sqrt((ep + ef) * (ef + nf))
    if method == "jaccard":
        return ef / (ef + ep + nf)
    if method == "sorensendice":
        return 2 * ef / (2 * ef + ep + nf)
    if method == "m1":
        return (ef + np_) / (ep + nf)
    if method == "m2":
        return ef / (2 * ep + 2 * nf + ef + np_)
    if method == "goodman":
        return (2 * ef - nf - ep) / (2 * ef + nf + ep)
    if method == "tarantula":
        return ef / (ef + nf) / (ef / (ef + nf) + ep / (ep + np_))
    if method == "russellrao":
        return ef / (ef + nf + ep + np_)
    if method == "hamann":
        return (ef + np_ - ep - nf) / (ef + nf + ep + np_)
    if method == "dice":
        return 2 * ef / (ef + nf + ep)
    if method == "simplematcing":  # (sic) — the reference's spelling
        return (ef + np_) / (ef + np_ + nf + ep)
    if method == "rogers":
        return (ef + np_) / (ef + np_ + 2 * nf + 2 * ep)
    raise ValueError(f"unknown spectrum method {method!r}")


def _partition_arrays(g):
    """The live (unpadded) COO arrays of one partition."""
    if int(g.n_cols) >= 0:
        raise ValueError(
            "the sparse oracle ranks uncollapsed graphs only (its point is "
            "independence from the device path's transformations): build "
            "the window with collapse='off'"
        )
    e = int(g.n_inc)
    c = int(g.n_ss)
    t = int(g.n_traces)
    return {
        "inc_op": np.asarray(g.inc_op[:e]),
        "inc_trace": np.asarray(g.inc_trace[:e]),
        "sr_val": np.asarray(g.sr_val[:e], dtype=np.float64),
        "rs_val": np.asarray(g.rs_val[:e], dtype=np.float64),
        "ss_child": np.asarray(g.ss_child[:c]),
        "ss_parent": np.asarray(g.ss_parent[:c]),
        "ss_val": np.asarray(g.ss_val[:c], dtype=np.float64),
        # g.kind is not read: the kinds are grouped again here.
        "tracelen": np.asarray(g.tracelen[:t], dtype=np.float64),
        "op_present": np.asarray(g.op_present),
        "n_ops": int(g.n_ops),
        "n_traces": t,
    }


def recompute_kinds(inc_trace, inc_op, tracelen, n_traces: int) -> np.ndarray:
    """Trace-kind dedup (reference pagerank.py:54-66) by a per-trace byte
    signature: two traces are one kind iff they have the same unique op
    set and the same with-duplicates length. Returns counts[t], the size
    of t's kind."""
    order = np.lexsort((inc_op, inc_trace))
    tr = inc_trace[order]
    op = inc_op[order]
    starts = np.searchsorted(tr, np.arange(n_traces), side="left")
    n_unique = np.searchsorted(tr, np.arange(n_traces), side="right") - starts
    # The length as float64 bits: equal floats, equal bits (lengths are
    # positive counts).
    tlen_bits = np.asarray(tracelen, dtype=np.float64)[:n_traces].view(np.int64)
    # Traces with the same number of unique ops, grouped by their rows of
    # (sorted ops, length): one sort per distinct count, not a dict
    # lookup per trace.
    kind_of = np.zeros(n_traces, dtype=np.int64)
    n_kinds = 0
    for m in np.unique(n_unique):
        idx = np.flatnonzero(n_unique == m)
        keys = np.column_stack(
            [op[starts[idx][:, None] + np.arange(m)].astype(np.int64), tlen_bits[idx]]
        )
        order = np.lexsort(keys.T[::-1])
        ranked = keys[order]
        first = np.ones(len(idx), dtype=bool)
        first[1:] = (ranked[1:] != ranked[:-1]).any(axis=1)
        kind_of[idx[order]] = n_kinds + np.cumsum(first) - 1
        n_kinds += int(first.sum())
    counts = np.bincount(kind_of, minlength=n_kinds)
    return counts[kind_of].astype(np.float64)


def _preference(kind, tracelen, anomaly: bool, cfg: PageRankConfig):
    """pagerank.py:68-85 in array form, float64."""
    inv_kind = 1.0 / kind
    inv_len = 1.0 / tracelen
    kind_sum = inv_kind.sum()
    if not anomaly:
        return inv_kind / kind_sum
    num_sum = inv_len.sum()
    if cfg.preference == "reference":
        return cfg.phi / num_sum / (kind / kind_sum * cfg.phi + inv_len)
    if cfg.preference == "paper":
        return cfg.phi * inv_len / num_sum + (1.0 - cfg.phi) * inv_kind / kind_sum
    raise ValueError(f"unknown preference form {cfg.preference!r}")


def _iterate_sparse(p, pref, v_pad: int, cfg: PageRankConfig):
    """pageRank (pagerank.py:116-130) over the COO entries: each matvec
    is a gather and a weighted bincount, in float64."""
    d = cfg.damping
    alpha = cfg.call_weight
    t = p["n_traces"]
    n_total = float(p["n_ops"] + t)
    v_s = np.where(p["op_present"], 1.0 / n_total, 0.0)
    v_r = np.full(t, 1.0 / n_total)
    for _ in range(cfg.iterations):
        sr = np.bincount(
            p["inc_op"], weights=p["sr_val"] * v_r[p["inc_trace"]], minlength=v_pad
        )
        ss = np.bincount(
            p["ss_child"], weights=p["ss_val"] * v_s[p["ss_parent"]], minlength=v_pad
        )
        new_s = d * (sr + alpha * ss)
        new_r = d * np.bincount(
            p["inc_trace"], weights=p["rs_val"] * v_s[p["inc_op"]], minlength=t
        ) + (1.0 - d) * pref
        if cfg.max_normalize_each_iter:
            new_s = new_s / np.amax(new_s)
            new_r = new_r / np.amax(new_r)
        if cfg.tol is not None:
            delta = max(
                float(np.max(np.abs(new_s - v_s))), float(np.max(np.abs(new_r - v_r)))
            )
            v_s, v_r = new_s, new_r
            if delta <= cfg.tol:
                break
        else:
            v_s, v_r = new_s, new_r
    return v_s / np.amax(v_s), v_r


def _partition_rank(g, anomaly: bool, cfg: PageRankConfig):
    """One partition's (weight[v_pad], trace_num[v_pad], arrays), with
    kinds and coverage counts computed again from the entries."""
    p = _partition_arrays(g)
    v_pad = g.op_present.shape[0]
    kinds = recompute_kinds(p["inc_trace"], p["inc_op"], p["tracelen"], p["n_traces"])
    pref = _preference(kinds, p["tracelen"], anomaly, cfg)
    v_s, _ = _iterate_sparse(p, pref, v_pad, cfg)
    total = float(v_s[p["op_present"]].sum())
    weight = np.where(p["op_present"], v_s * total / p["n_ops"], 0.0)
    trace_num = np.bincount(p["inc_op"], minlength=v_pad).astype(np.int64)
    return weight, trace_num, p


def rank_window_sparse(
    graph,
    op_names: List[str],
    pagerank_cfg: PageRankConfig = PageRankConfig(),
    spectrum_cfg: SpectrumConfig = SpectrumConfig(),
) -> Tuple[List[str], List[float]]:
    """The window's ranking from its padded host COO graph (numpy
    arrays): the top ``n_rows`` names and scores, exact ties broken by
    name, as the device path's vocab-index tie key over the name-sorted
    vocab does."""
    n_weight, n_num, n_p = _partition_rank(graph.normal, False, pagerank_cfg)
    a_weight, a_num, a_p = _partition_rank(graph.abnormal, True, pagerank_cfg)
    in_a = np.asarray(graph.abnormal.op_present)
    in_n = np.asarray(graph.normal.op_present)
    eps = spectrum_cfg.eps
    scored = {}
    for vi in np.flatnonzero(in_a | in_n):
        cell = {}
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
        else:  # the only-in-normal branch (online_rca.py:60-69, asymmetric)
            nw = n_weight[vi]
            cell["ef"] = eps
            cell["nf"] = eps
            cell["ep"] = (1 + nw) * n_num[vi]
            cell["np"] = n_p["n_traces"] - n_num[vi]
        scored[int(vi)] = spectrum_score(cell, spectrum_cfg.method)
    ranked = sorted(scored.items(), key=lambda x: (-x[1], op_names[x[0]]))
    top = ranked[: spectrum_cfg.n_rows]
    return [op_names[vi] for vi, _ in top], [float(s) for _, s in top]
