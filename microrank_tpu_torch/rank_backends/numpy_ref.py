"""Faithful numpy oracle backend (counterpart of
``microrank_tpu/rank_backends/numpy_ref.py``; reference components
C9-C14), the serve lane's degradation path.

Re-derives the reference's ranking semantics — ``trace_pagerank``
(the reference's pagerank.py:15-112), ``pageRank`` (pagerank.py:116-130) and
``calculate_spectrum_without_delay_list`` (online_rca.py:33-152) — against
the SURVEY.md §2 citations, value-for-value, including the documented
quirks. This is the parity oracle for the device program: it is written for
clarity and exactness, not speed (the O(n) ``list.index`` lookups become
dict lookups and the O(T^2·O) kind dedup becomes ``np.unique`` — both
produce identical values).

Dtype fidelity: transition matrices are float32 (pagerank.py:19-24), the
ranking vectors start as numpy default float64 (``np.ones`` at
pagerank.py:118-119) and stay float64 through the iteration because
float32 @ float64 promotes.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import PageRankConfig, SpectrumConfig

EPS_DEFAULT = 1e-7


def page_rank_iterate(
    p_ss: np.ndarray,
    p_sr: np.ndarray,
    p_rs: np.ndarray,
    pref: np.ndarray,
    n_ops: int,
    n_traces: int,
    cfg: PageRankConfig,
    record: Optional[List[float]] = None,
) -> np.ndarray:
    """Power iteration (reference ``pageRank``, pagerank.py:116-130).

    Fixed iteration count, no convergence check (tol=None, the reference
    behavior); both vectors are max-normalized every iteration
    (pagerank.py:126-127 — not in the paper but load-bearing for score
    parity). ``cfg.tol`` adds the same early-exit rule as the device
    backend: stop once the L-inf change of both vectors is below tol.

    ``record``: list the per-iteration L-inf residual (max over both
    vectors, AFTER normalization) is appended to — the oracle twin of
    the device convergence trace (torch_cuda.rank_window_traced_core), same
    definition so the parity suite can pin them against each other.
    """
    d = cfg.damping
    alpha = cfg.call_weight
    v_s = np.ones((n_ops, 1)) / float(n_ops + n_traces)
    v_r = np.ones((n_traces, 1)) / float(n_ops + n_traces)
    for _ in range(cfg.iterations):
        new_s = d * (np.dot(p_sr, v_r) + alpha * np.dot(p_ss, v_s))
        new_r = d * np.dot(p_rs, v_s) + (1.0 - d) * pref
        if cfg.max_normalize_each_iter:
            new_s = new_s / np.amax(new_s)
            new_r = new_r / np.amax(new_r)
        need_delta = cfg.tol is not None or record is not None
        if need_delta:
            delta = max(
                float(np.max(np.abs(new_s - v_s))),
                float(np.max(np.abs(new_r - v_r))),
            )
            if record is not None:
                record.append(delta)
        v_s, v_r = new_s, new_r
        if cfg.tol is not None and delta <= cfg.tol:
            break
    return v_s / np.amax(v_s)


def _preference_vector(
    trace_index: Dict[str, int],
    pr_trace: Dict[str, List[str]],
    kind_list: np.ndarray,
    anomaly: bool,
    cfg: PageRankConfig,
) -> np.ndarray:
    """Personalized preference vector (pagerank.py:68-85).

    ``preference="reference"`` reproduces the code exactly — note the
    anomalous form deviates from paper Eq (7) (SURVEY.md §2.2 quirk #4).
    ``preference="paper"`` implements Eq (7): the phi-weighted sum of the
    normalized 1/n_t and 1/kind_t terms.
    """
    n = len(trace_index)
    pr = np.zeros((n, 1), dtype=np.float32)
    inv_kind = {t: 1.0 / kind_list[trace_index[t]] for t in pr_trace}
    inv_len = {t: 1.0 / len(pr_trace[t]) for t in pr_trace}

    if not anomaly:
        kind_sum = sum(inv_kind.values())
        for t in pr_trace:
            pr[trace_index[t]] = inv_kind[t] / kind_sum
        return pr

    if cfg.preference == "reference":
        kind_sum = sum(inv_kind.values())
        num_sum = sum(inv_len.values())
        for t in pr_trace:
            kind_t = kind_list[trace_index[t]]
            pr[trace_index[t]] = (
                1.0
                / (kind_t / kind_sum * cfg.phi + inv_len[t])
                / num_sum
                * cfg.phi
            )
    elif cfg.preference == "paper":
        kind_sum = sum(inv_kind.values())
        num_sum = sum(inv_len.values())
        for t in pr_trace:
            pr[trace_index[t]] = cfg.phi * inv_len[t] / num_sum + (
                1.0 - cfg.phi
            ) * inv_kind[t] / kind_sum
    else:
        raise ValueError(f"unknown preference form {cfg.preference!r}")
    return pr


def build_matrices(
    operation_operation: Dict[str, List[str]],
    operation_trace: Dict[str, List[str]],
    trace_operation: Dict[str, List[str]],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[str], List[str]]:
    """Dense float32 transition matrices (pagerank.py:19-52).

    Returns (p_ss, p_sr, p_rs, node_list, trace_list). The call-graph
    matrix's duplicate children overwrite to the same value, so
    multiplicity only inflates the 1/child_num denominator
    (pagerank.py:35-39).
    """
    node_list = list(operation_operation.keys())
    trace_list = list(operation_trace.keys())
    node_index = {n: i for i, n in enumerate(node_list)}
    trace_index = {t: i for i, t in enumerate(trace_list)}
    n_ops = len(node_list)
    n_traces = len(trace_list)

    p_ss = np.zeros((n_ops, n_ops), dtype=np.float32)
    p_sr = np.zeros((n_ops, n_traces), dtype=np.float32)
    p_rs = np.zeros((n_traces, n_ops), dtype=np.float32)

    for operation, children in operation_operation.items():
        if not children:
            continue
        child_num = len(children)
        for child in children:
            p_ss[node_index[child]][node_index[operation]] = 1.0 / child_num

    for trace_id, ops in operation_trace.items():
        child_num = len(ops)
        for op in ops:
            p_sr[node_index[op]][trace_index[trace_id]] = 1.0 / child_num

    for operation, traces in trace_operation.items():
        child_num = len(traces)
        for trace_id in traces:
            p_rs[trace_index[trace_id]][node_index[operation]] = 1.0 / child_num

    return p_ss, p_sr, p_rs, node_list, trace_list


def compute_kind_list(p_sr: np.ndarray) -> np.ndarray:
    """Trace-kind dedup (pagerank.py:54-66): kind_list[t] = number of traces
    whose p_sr column is identical to t's. np.unique over columns gives the
    same float-equality grouping as the all-pairs loop, at O(T log T)."""
    n_traces = p_sr.shape[1]
    if not n_traces:
        return np.zeros(0)
    _, inverse, counts = np.unique(
        p_sr.T, axis=0, return_inverse=True, return_counts=True
    )
    return counts[inverse].astype(np.float64)


def trace_pagerank(
    operation_operation: Dict[str, List[str]],
    operation_trace: Dict[str, List[str]],
    trace_operation: Dict[str, List[str]],
    pr_trace: Dict[str, List[str]],
    anomaly: bool,
    cfg: PageRankConfig = PageRankConfig(),
    record: Optional[List[float]] = None,
) -> Tuple[Dict[str, float], Dict[str, int]]:
    """Reference ``trace_pagerank`` (pagerank.py:15-112), value-identical.

    Returns (weight, trace_num_list): the rescaled operation scores
    (``score * sum(scores) / n_ops``, rank-preserving — pagerank.py:106-107)
    and the per-op count of distinct covering traces (N_ef / N_ep for the
    spectrum step).
    """
    p_ss, p_sr, p_rs, node_list, trace_list = build_matrices(
        operation_operation, operation_trace, trace_operation
    )
    node_index = {n: i for i, n in enumerate(node_list)}
    trace_index = {t: i for i, t in enumerate(trace_list)}
    n_ops = len(node_list)
    n_traces = len(trace_list)

    kind_list = compute_kind_list(p_sr)

    pref = _preference_vector(trace_index, pr_trace, kind_list, anomaly, cfg)

    result = page_rank_iterate(
        p_ss, p_sr, p_rs, pref, n_ops, n_traces, cfg, record=record
    )

    total = float(sum(result[node_index[op]][0] for op in operation_operation))
    trace_num_list = {
        op: int(np.count_nonzero(p_sr[node_index[op]]))
        for op in operation_operation
    }
    weight = {
        op: result[node_index[op]][0] * total / n_ops
        for op in operation_operation
    }
    return weight, trace_num_list


def spectrum_components(
    anomaly_result: Dict[str, float],
    normal_result: Dict[str, float],
    anomaly_list_len: int,
    normal_list_len: int,
    normal_num_list: Dict[str, int],
    anomaly_num_list: Dict[str, int],
    eps: float = EPS_DEFAULT,
) -> Dict[str, Dict[str, float]]:
    """Per-op spectrum counters {ef, nf, ep, np} (online_rca.py:43-69).

    Note the asymmetric only-in-normal branch: ep = (1+P)*N_ep and
    np = N_p - N_ep (online_rca.py:65-66).
    """
    spectrum: Dict[str, Dict[str, float]] = {}
    for node, score in anomaly_result.items():
        cell = spectrum[node] = {}
        cell["ef"] = score * anomaly_num_list[node]
        cell["nf"] = score * (anomaly_list_len - anomaly_num_list[node])
        if node in normal_result:
            cell["ep"] = normal_result[node] * normal_num_list[node]
            cell["np"] = normal_result[node] * (
                normal_list_len - normal_num_list[node]
            )
        else:
            cell["ep"] = eps
            cell["np"] = eps
    for node, score in normal_result.items():
        if node not in spectrum:
            cell = spectrum[node] = {}
            cell["ep"] = (1 + score) * normal_num_list[node]
            cell["np"] = normal_list_len - normal_num_list[node]
            if node not in anomaly_result:
                cell["ef"] = eps
                cell["nf"] = eps
    return spectrum


def spectrum_score(cell: Dict[str, float], method: str) -> float:
    """The 13 spectrum formulas (online_rca.py:75-142), scalar form."""
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
    if method == "simplematcing":  # (sic) — reference spelling
        return (ef + np_) / (ef + np_ + nf + ep)
    if method == "rogers":
        return (ef + np_) / (ef + np_ + 2 * nf + 2 * ep)
    raise ValueError(f"unknown spectrum method {method!r}")


def calculate_spectrum(
    anomaly_result: Dict[str, float],
    normal_result: Dict[str, float],
    anomaly_list_len: int,
    normal_list_len: int,
    normal_num_list: Dict[str, int],
    anomaly_num_list: Dict[str, int],
    cfg: SpectrumConfig = SpectrumConfig(),
) -> Tuple[List[str], List[float]]:
    """Reference ``calculate_spectrum_without_delay_list``
    (online_rca.py:33-152): score every op, return the top
    ``top_max + extra_rows`` (score descending).

    Exactly tied scores order by ``cfg.tiebreak``: "name" (ascending op
    name — matches the device path, whose vocab-index tie key runs over
    the name-sorted window vocab) or "insertion" (the reference's
    accidental dict-insertion order under Python's stable sort)."""
    spectrum = spectrum_components(
        anomaly_result,
        normal_result,
        anomaly_list_len,
        normal_list_len,
        normal_num_list,
        anomaly_num_list,
        eps=cfg.eps,
    )
    result = {
        node: spectrum_score(cell, cfg.method) for node, cell in spectrum.items()
    }
    if cfg.tiebreak == "name":
        ranked = sorted(result.items(), key=lambda x: (-x[1], x[0]))
    elif cfg.tiebreak == "insertion":
        ranked = sorted(result.items(), key=lambda x: x[1], reverse=True)
    else:
        raise ValueError(f"unknown tiebreak {cfg.tiebreak!r}")
    top_list: List[str] = []
    score_list: List[float] = []
    for index, (node, score) in enumerate(ranked):
        if index < cfg.n_rows:
            top_list.append(node)
            score_list.append(float(score))
    return top_list, score_list


def rank_window_dicts(
    normal_graph,
    abnormal_graph,
    n_normal_traces: int,
    n_abnormal_traces: int,
    pagerank_cfg: PageRankConfig = PageRankConfig(),
    spectrum_cfg: SpectrumConfig = SpectrumConfig(),
    conv_out: Optional[dict] = None,
) -> Tuple[List[str], List[float]]:
    """Full oracle ranking of one window from the two partitions' graph
    dicts — the composition the orchestrator performs at
    online_rca.py:180-201.

    ``conv_out``: dict the per-partition residual traces are written
    into ({"normal": [...], "abnormal": [...]}) — the oracle side of
    the convergence-trace parity suite."""
    rec_n = [] if conv_out is not None else None
    rec_a = [] if conv_out is not None else None
    normal_result, normal_num = trace_pagerank(
        *normal_graph, False, pagerank_cfg, record=rec_n
    )
    anomaly_result, anomaly_num = trace_pagerank(
        *abnormal_graph, True, pagerank_cfg, record=rec_a
    )
    if conv_out is not None:
        conv_out["normal"] = rec_n
        conv_out["abnormal"] = rec_a
        conv_out["iterations"] = max(len(rec_n), len(rec_a))
    return calculate_spectrum(
        anomaly_result=anomaly_result,
        normal_result=normal_result,
        anomaly_list_len=n_abnormal_traces,
        normal_list_len=n_normal_traces,
        normal_num_list=normal_num,
        anomaly_num_list=anomaly_num,
        cfg=spectrum_cfg,
    )
