"""``ExplainContext``: per partition, each coverage column's
representative trace id and multiplicity (counterpart of
``microrank_tpu/explain/bundle.py:42-75``). The warm start's trace axis
maps by it (``rank_backends.warm.map_warm_state``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


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
