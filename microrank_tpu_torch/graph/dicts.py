"""Dict-form PageRank graphs of one window, from ``SpanTable`` rows
(counterpart of ``microrank_tpu/graph/dicts.py``, which builds them from
a pandas frame; reference ``get_pagerank_graph``,
preprocess_data.py:146-171).

The dicts are the numpy oracle's input (``rank_backends.numpy_ref``),
built in the JAX package's key order so that its iteration sums in the
same order:

* ``operation_operation[parent] = [child, ...]``: one entry per call
  edge (duplicates kept), parents in sorted name order (pandas'
  ``groupby``), then every childless op with ``[]`` in its first
  appearance over the rows;
* ``operation_trace[trace] = [op, ...]``: traces in sorted name order,
  each trace's ops in row order;
* ``trace_operation[op] = [trace, ...]``: ops in sorted name order, each
  op's traces in row order;
* ``pr_trace``: a copy of ``operation_trace`` (the reference's two
  content-identical groupbys).

The call edges join a span to its parent row (``SpanTable.parent_row``,
the loader's span id lookup) where both rows belong to the partition's
traces, as JAX's merge on ``ParentSpanId == spanID`` over the partition's
rows does.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np

GraphDicts = Tuple[
    Dict[str, List[str]],  # operation_operation
    Dict[str, List[str]],  # operation_trace: trace -> [op, ...] (with dups)
    Dict[str, List[str]],  # trace_operation: op -> [trace, ...] (with dups)
    Dict[str, List[str]],  # pr_trace (== operation_trace)
]


def pagerank_graph_dicts(trace_codes: Iterable[int], table) -> GraphDicts:
    """The four dicts of the partition ``trace_codes`` (codes into
    ``table.trace_names``) over ``table``'s rows, in row order."""
    codes = np.asarray(list(trace_codes), dtype=np.int64)
    in_part = np.zeros(len(table.trace_names), dtype=bool)
    in_part[codes] = True
    row_in = in_part[table.trace_id]
    rows = np.flatnonzero(row_in)
    op_names, trace_names = table.pod_op_names, table.trace_names
    ops = [op_names[i] for i in table.pod_op[rows].tolist()]
    traces = [trace_names[i] for i in table.trace_id[rows].tolist()]

    parent = table.parent_row[rows]
    linked = parent >= 0
    linked[linked] = row_in[parent[linked]]
    children: Dict[str, List[str]] = {}
    pod_op = table.pod_op
    for child, par in zip(table.pod_op[rows[linked]].tolist(),
                          pod_op[parent[linked]].tolist()):
        children.setdefault(op_names[par], []).append(op_names[child])
    operation_operation = {k: children[k] for k in sorted(children)}
    for op in dict.fromkeys(ops):
        if op not in operation_operation:
            operation_operation[op] = []

    by_trace: Dict[str, List[str]] = {}
    by_op: Dict[str, List[str]] = {}
    for op, tr in zip(ops, traces):
        by_trace.setdefault(tr, []).append(op)
        by_op.setdefault(op, []).append(tr)
    operation_trace = {k: by_trace[k] for k in sorted(by_trace)}
    trace_operation = {k: by_op[k] for k in sorted(by_op)}
    pr_trace = {k: list(v) for k, v in operation_trace.items()}
    return operation_operation, operation_trace, trace_operation, pr_trace
