"""Warm-start state capture and mapping across the sliding-window delta
(counterpart of ``microrank_tpu/rank_backends/warm.py``; host only).

The host half of K19: it captures the converged per-partition state a
warm rank program exports (``torch_cuda.rank_window_warm_core``:
max-normalized score [V] and trace mass rv [T] per partition) and maps
it onto the next window's axes:

* the op axis by name: both windows intern their ops in sorted name
  order (``stream.window.window_table``), but membership shifts with the
  delta, so the join is the name itself;
* the trace (kind column) axis by each column's representative trace id
  (``explain.ExplainContext``; identity when uncollapsed): overlapping
  windows share trace ids, so a surviving kind's mass carries over; a
  regrouped or departed kind misses.

Misses map to 0 and the iteration refills them; a side that misses
entirely falls back to its cold vector in the set-up (K19's masked
maximum, ``ops.setup.warm_override_plain``), so a bad map can make a
warm start cold but never corrupt a ranking.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class WarmState:
    """One ranked window's converged iteration state and the axis labels
    needed to map it onto a later window."""

    op_names: List[str]
    col_ids_n: List           # normal partition: per-column trace id
    col_ids_a: List           # abnormal partition: per-column trace id
    score_n: np.ndarray       # float32[V_prev] final normalized sv
    rv_n: np.ndarray          # float32[T_prev] final trace/kind mass
    score_a: np.ndarray
    rv_a: np.ndarray


def capture_warm_state(op_names, ectx, fetched) -> WarmState:
    """A warm program's fetched state tail (score_n, rv_n, score_a, rv_a,
    host arrays) as a WarmState keyed by this window's op names and the
    retention context's per-column trace ids."""
    sc_n, rv_n, sc_a, rv_a = (np.asarray(x, np.float32) for x in fetched)
    return WarmState(
        op_names=list(op_names),
        col_ids_n=list(ectx.normal_trace_ids),
        col_ids_a=list(ectx.abnormal_trace_ids),
        score_n=sc_n,
        rv_n=rv_n,
        score_a=sc_a,
        rv_a=rv_a,
    )


def _map_axis(prev_vals: np.ndarray, prev_keys, new_keys, pad: int) -> np.ndarray:
    """Value-carrying join: out[i] = prev_vals[prev_index[new_keys[i]]]
    (0 on a miss), zero-padded to ``pad``."""
    index = {k: i for i, k in enumerate(prev_keys)}
    out = np.zeros(pad, np.float32)
    for i, k in enumerate(new_keys):
        j = index.get(k)
        if j is not None and j < len(prev_vals):
            out[i] = prev_vals[j]
    return out


def map_warm_state(
    prev: Optional[WarmState], op_names, ectx, graph
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """The (sv_n, rv_n, sv_a, rv_a) init of a new window's warm rank,
    mapped from ``prev`` across the window delta, or None when there is
    nothing to map (a cold first window)."""
    if prev is None:
        return None
    v_pad = int(graph.normal.cov_unique.shape[-1])
    t_pad_n = int(graph.normal.kind.shape[-1])
    t_pad_a = int(graph.abnormal.kind.shape[-1])
    sv_n = _map_axis(prev.score_n, prev.op_names, op_names, v_pad)
    sv_a = _map_axis(prev.score_a, prev.op_names, op_names, v_pad)
    rv_n = _map_axis(prev.rv_n, prev.col_ids_n, ectx.normal_trace_ids, t_pad_n)
    rv_a = _map_axis(prev.rv_a, prev.col_ids_a, ectx.abnormal_trace_ids, t_pad_a)
    return sv_n, rv_n, sv_a, rv_a
