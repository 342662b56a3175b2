"""Segment-reduction primitives (counterpart of
``microrank_tpu/ops/segment.py``, the part the rank program uses)."""

from __future__ import annotations

import torch


def coo_matvec(rows, cols, vals, x, n_rows: int):
    """y = A @ x for COO entries A[rows[i], cols[i]] = vals[i]: a gather
    plus a segment sum, the plain form of JAX's
    ``jax.ops.segment_sum(vals * take(x, cols), rows)``.

    Padding entries must carry ``vals == 0``; they then contribute
    nothing. Indices may be int32 or int64.
    """
    y = torch.zeros(n_rows, dtype=torch.float32, device=x.device)
    return y.index_add_(0, rows, vals * x.index_select(0, cols))
