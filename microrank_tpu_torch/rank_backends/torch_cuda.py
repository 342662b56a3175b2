"""The per-window rank program on torch tensors (counterpart of
``microrank_tpu/rank_backends/jax_tpu.py``, ``kernel="pallas"`` only):

    preference vectors -> 25 power-iteration steps over both partitions
    -> rescale -> spectrum counters -> formula -> tie-broken top-k

Every step's three SpMVs per partition go through K1
(``ops.spmv.coo_spmv``: the CUDA kernel on the card, its plain version
on the CPU). The loop issues device work only — no step reads a value
back — and the caller fetches ``(top_idx, top_scores, n_valid,
residuals, n_iters)`` in one device-to-host copy (``fetch_rank_outputs``).
With a convergence ``tol`` the loop still runs ``iterations`` steps,
freezing the carry with ``torch.where`` once a device-side "still
running" flag drops, so no step branches on a device value; vectors,
residuals (zero past ``n_iters``) and ``n_iters`` come out as JAX's
``lax.while_loop`` gives them.

Scalars that JAX keeps as float32 (damping, call weight, eps, tol) are
float32 0-d tensors here, so each product rounds in float32 as it does
there.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import KERNELS, PageRankConfig, SpectrumConfig
from ..graph.structures import PartitionGraph, WindowGraph
from ..ops.spmv import RowLayout, coo_spmv, row_layout
from ..spectrum.formulas import spectrum_scores


def _f32(value: float, device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


def _check_kernel(kernel: str) -> None:
    if kernel not in KERNELS:
        raise NotImplementedError(
            f"kernel={kernel!r} is not ported (this package runs "
            "kernel='pallas'; see ROADMAP.md's port queue)"
        )


def preference_vector(g: PartitionGraph, anomaly: bool, cfg: PageRankConfig):
    """Personalized preference vector on the padded trace axis
    (reference: pagerank.py:68-85; paper Eq (7) behind
    preference="paper"). On a kind-collapsed graph a column stands for
    ``kind`` identical traces, so the two normalization sums weight each
    column by its multiplicity."""
    t_pad = g.kind.shape[0]
    dev = g.kind.device
    collapsed = g.n_cols >= 0
    n_live = torch.where(collapsed, g.n_cols, g.n_traces)
    live = torch.arange(t_pad, device=dev) < n_live
    kind = g.kind.to(torch.float32)
    tlen = g.tracelen.to(torch.float32)
    mult = torch.where(collapsed, kind, 1.0)
    inv_kind = torch.where(live, 1.0 / kind, 0.0)
    inv_len = torch.where(live, 1.0 / tlen, 0.0)
    kind_sum = (mult * inv_kind).sum()
    num_sum = (mult * inv_len).sum()

    if not anomaly:
        pref = inv_kind / kind_sum
    elif cfg.preference == "reference":
        # The code's anomalous form (deviates from paper Eq (7)):
        # phi / num_sum / (kind/kind_sum*phi + 1/n).
        phi = _f32(cfg.phi, dev)
        pref = phi / num_sum / (kind / kind_sum * phi + inv_len)
    elif cfg.preference == "paper":
        phi = _f32(cfg.phi, dev)
        pref = phi * inv_len / num_sum + (1.0 - phi) * inv_kind / kind_sum
    else:
        raise ValueError(f"unknown preference form {cfg.preference!r}")
    return torch.where(live, pref, 0.0)


def spmv_layouts(g: PartitionGraph) -> Tuple[RowLayout, RowLayout, RowLayout]:
    """K1's row layouts of the partition's three transition matrices:
    p_sr (rows = op, over traces), p_ss (rows = child op, over parent
    ops) and p_rs (rows = trace, over ops). Entries past the live
    counts are padding and are left out."""
    v = g.cov_unique.shape[0]
    t_pad = g.kind.shape[0]
    return (
        row_layout(g.inc_op, g.inc_trace, g.sr_val, v, g.n_inc),
        row_layout(g.ss_child, g.ss_parent, g.ss_val, v, g.n_ss),
        row_layout(g.inc_trace, g.inc_op, g.rs_val, t_pad, g.n_inc),
    )


def _partition_setup(
    g: PartitionGraph, anomaly: bool, cfg: PageRankConfig, kernel: str = "pallas"
):
    """One partition's iteration ingredients: (matvecs, pref, sv0, rv0)."""
    _check_kernel(kernel)
    dev = g.kind.device
    t_pad = g.kind.shape[0]
    n_total = (g.n_ops + g.n_traces).to(torch.float32)
    n_live_cols = torch.where(g.n_cols < 0, g.n_traces, g.n_cols)
    trace_live = torch.arange(t_pad, device=dev) < n_live_cols
    pref = preference_vector(g, anomaly, cfg)
    alpha = _f32(cfg.call_weight, dev)
    init = 1.0 / n_total
    sv = torch.where(g.op_present, init, 0.0)
    rv = torch.where(trace_live, init, 0.0)
    p_sr, p_ss, p_rs = g.row_layouts or spmv_layouts(g)

    def matvecs(sv, rv):
        return (
            coo_spmv(p_sr, rv) + alpha * coo_spmv(p_ss, sv),
            coo_spmv(p_rs, sv),
        )

    return matvecs, pref, sv, rv


def _partition_step(matvecs, pref, sv, rv, cfg: PageRankConfig, d):
    """One power-iteration step (pagerank.py:122-127):
    sv' = d*(p_sr @ rv + alpha * p_ss @ sv);
    rv' = d*(p_rs @ sv) + (1-d) * pref; both max-normalized."""
    mv_s, mv_r = matvecs(sv, rv)
    sv_new = d * mv_s
    rv_new = d * mv_r + (1.0 - d) * pref
    if cfg.max_normalize_each_iter:
        sv_new = sv_new / sv_new.max()
        rv_new = rv_new / rv_new.max()
    return sv_new, rv_new


def _partition_finish(g: PartitionGraph, sv):
    """Final normalize + the reference's rescale (pagerank.py:93-112):
    returns (weight[V], score[V])."""
    score = sv / sv.max()
    total = torch.where(g.op_present, score, 0.0).sum()
    weight = score * total / g.n_ops.to(torch.float32)
    return weight, score


def window_weights_full(
    graph: WindowGraph, pagerank_cfg: PageRankConfig, kernel: str = "pallas"
):
    """Both partitions' PageRank weights, stepped together, with the
    per-partition convergence trace.

    Returns (n_weight[V], a_weight[V], rv_n[T_n], rv_a[T_a],
    residuals[2, I], n_iters int32, score_n[V], score_a[V]); residual
    row 0 is the normal partition, row 1 the abnormal one.
    """
    cfg = pagerank_cfg
    mv_n, pref_n, sv_n, rv_n = _partition_setup(graph.normal, False, cfg, kernel)
    mv_a, pref_a, sv_a, rv_a = _partition_setup(graph.abnormal, True, cfg, kernel)
    dev = sv_n.device
    d = _f32(cfg.damping, dev)
    n_steps = int(cfg.iterations)

    def part_delta(new, old):
        return torch.maximum(
            (new[0] - old[0]).abs().max(), (new[1] - old[1]).abs().max()
        )

    def step(carry):
        old_n, old_a = carry
        new_n = _partition_step(mv_n, pref_n, *old_n, cfg, d)
        new_a = _partition_step(mv_a, pref_a, *old_a, cfg, d)
        deltas = torch.stack([part_delta(new_n, old_n), part_delta(new_a, old_a)])
        return (new_n, new_a), deltas

    carry = ((sv_n, rv_n), (sv_a, rv_a))
    residuals = torch.zeros((2, n_steps), dtype=torch.float32, device=dev)
    if cfg.tol is None:
        for i in range(n_steps):
            carry, deltas = step(carry)
            residuals[:, i] = deltas
        n_iters = torch.tensor(n_steps, dtype=torch.int32, device=dev)
    else:
        tol = _f32(cfg.tol, dev)
        running = torch.ones((), dtype=torch.bool, device=dev)
        n_iters = torch.zeros((), dtype=torch.int32, device=dev)
        for i in range(n_steps):
            new, deltas = step(carry)
            carry = tuple(
                tuple(torch.where(running, a, b) for a, b in zip(pn, po))
                for pn, po in zip(new, carry)
            )
            residuals[:, i] = torch.where(running, deltas, 0.0)
            n_iters = n_iters + running.to(torch.int32)
            running = running & (deltas.max() > tol)
    (sv_n, rv_n), (sv_a, rv_a) = carry
    n_weight, score_n = _partition_finish(graph.normal, sv_n)
    a_weight, score_a = _partition_finish(graph.abnormal, sv_a)
    return n_weight, a_weight, rv_n, rv_a, residuals, n_iters, score_n, score_a


def spectrum_counters(
    a_weight,
    a_graph: PartitionGraph,
    n_weight,
    n_graph: PartitionGraph,
    cfg: SpectrumConfig,
):
    """The spectrum counters {ef, nf, ep, np} over the shared op vocab
    (reference: online_rca.py:43-69, incl. the asymmetric only-in-normal
    branch at :65-66). Returns (ef, nf, ep, np_, valid)."""
    eps = _f32(cfg.eps, a_weight.device)
    a_present = a_graph.op_present
    n_present = n_graph.op_present
    a_cov = a_graph.cov_unique.to(torch.float32)
    n_cov = n_graph.cov_unique.to(torch.float32)
    a_len = a_graph.n_traces.to(torch.float32)
    n_len = n_graph.n_traces.to(torch.float32)

    ef = torch.where(a_present, a_weight * a_cov, eps)
    nf = torch.where(a_present, a_weight * (a_len - a_cov), eps)
    ep = torch.where(
        a_present,
        torch.where(n_present, n_weight * n_cov, eps),
        (1.0 + n_weight) * n_cov,
    )
    np_ = torch.where(
        a_present,
        torch.where(n_present, n_weight * (n_len - n_cov), eps),
        n_len - n_cov,
    )
    valid = a_present | n_present
    return ef, nf, ep, np_, valid


def window_spectrum(a_weight, a_graph, n_weight, n_graph, cfg: SpectrumConfig):
    """Spectrum counters + formula; invalid ops score -inf. Returns
    (scores[V], valid[V])."""
    ef, nf, ep, np_, valid = spectrum_counters(
        a_weight, a_graph, n_weight, n_graph, cfg
    )
    scores = spectrum_scores(ef, nf, ep, np_, cfg.method)
    return torch.where(valid, scores, float("-inf")), valid


def top_k_tiebroken(scores, k: int):
    """Top-k by score descending, op index ascending on EXACT ties —
    what JAX's two-key ``lax.sort`` gives. ``torch.topk`` is not
    tie-stable; a stable ascending sort of the negated scores keeps
    equal keys in index order. ``+ 0.0`` turns -0.0 into +0.0 so the two
    zeros cannot split. Returns (top_scores[k], top_idx[k])."""
    neg = -(scores + 0.0)
    neg_sorted, idx_sorted = torch.sort(neg, stable=True)
    return -neg_sorted[:k], idx_sorted[:k].to(torch.int32)


def _finish_topk(graph: WindowGraph, n_weight, a_weight, spectrum_cfg):
    """Spectrum + top-k tail: (top_idx int32[k], top_scores float32[k],
    n_valid int32)."""
    scores, valid = window_spectrum(
        a_weight, graph.abnormal, n_weight, graph.normal, spectrum_cfg
    )
    k = min(spectrum_cfg.n_rows, scores.shape[0])
    top_scores, top_idx = top_k_tiebroken(scores, k)
    n_valid = torch.clamp(valid.sum(), max=k).to(torch.int32)
    return top_idx, top_scores, n_valid


def rank_window_traced_core(
    graph: WindowGraph,
    pagerank_cfg: PageRankConfig,
    spectrum_cfg: SpectrumConfig,
    kernel: str = "pallas",
):
    """The full single-window ranking with its convergence trace:
    (top_idx int32[k], top_scores float32[k], n_valid int32,
    residuals float32[2, I], n_iters int32), all still on the device.
    Indices point into the shared window op vocab; entries past
    ``n_valid`` are padding (score -inf)."""
    n_weight, a_weight, _, _, residuals, n_iters, _, _ = window_weights_full(
        graph, pagerank_cfg, kernel
    )
    top_idx, top_scores, n_valid = _finish_topk(
        graph, n_weight, a_weight, spectrum_cfg
    )
    return top_idx, top_scores, n_valid, residuals, n_iters


def fetch_rank_outputs(outs):
    """One device-to-host copy of rank_window_traced_core's outputs:
    the five tensors are packed into one float32 buffer (int32 values
    ride bit-for-bit through ``view``) and unpacked on the host as
    numpy (top_idx, top_scores, n_valid, residuals, n_iters)."""
    top_idx, top_scores, n_valid, residuals, n_iters = outs
    k = top_idx.shape[0]
    packed = torch.cat(
        [
            top_idx.view(torch.float32),
            top_scores,
            n_valid.reshape(1).view(torch.float32),
            residuals.reshape(-1),
            n_iters.reshape(1).view(torch.float32),
        ]
    ).cpu()
    host = packed.numpy()
    return (
        host[:k].view(np.int32).copy(),
        host[k: 2 * k].copy(),
        int(host[2 * k: 2 * k + 1].view(np.int32)[0]),
        host[2 * k + 1: -1].reshape(residuals.shape).copy(),
        int(host[-1:].view(np.int32)[0]),
    )


def device_subset(graph: WindowGraph, kernel: str = "pallas") -> WindowGraph:
    """The graph as the kernel consumes it: each partition caches K1's
    row layouts (``row_layouts``), built here once per window so the
    power iteration only launches SpMVs. (JAX's device_subset strips the
    fields a kernel never reads before staging; the pallas kernel reads
    the COO arrays, and the native build leaves the other views empty.)"""
    _check_kernel(kernel)
    return WindowGraph(
        normal=graph.normal._replace(row_layouts=spmv_layouts(graph.normal)),
        abnormal=graph.abnormal._replace(row_layouts=spmv_layouts(graph.abnormal)),
    )
