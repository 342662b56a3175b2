"""Carry host state into the port: numpy graphs and baselines to the
port's structures.

``graph_from_numpy`` takes any object whose ``.normal`` and ``.abnormal``
expose the PartitionGraph field names as arrays — this package's host
graphs, or the JAX package's own — and returns the port's WindowGraph of
torch tensors on ``device``. It reads fields by name (duck typing), so
the port never imports the JAX package; the parity tests feed JAX's
graphs through it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..graph.structures import PartitionGraph, SloBaseline, WindowGraph
from ..io.interning import Vocab

_FIELDS = PartitionGraph._fields


def _tensor(value, device) -> torch.Tensor:
    return torch.tensor(np.asarray(value), device=device)


def _partition(src, device) -> PartitionGraph:
    defaults = PartitionGraph._field_defaults
    return PartitionGraph(
        **{
            f: _tensor(getattr(src, f, defaults.get(f)), device)
            for f in _FIELDS
        }
    )


def graph_from_numpy(graph, device) -> WindowGraph:
    """The port's WindowGraph of tensors on ``device`` from any graph
    whose partitions carry the PartitionGraph field names."""
    device = torch.device(device)
    return WindowGraph(
        normal=_partition(graph.normal, device),
        abnormal=_partition(graph.abnormal, device),
    )


def baseline_from_numpy(
    names: Sequence[str], mu, sigma
) -> Tuple[Vocab, SloBaseline]:
    """The port's (Vocab, SloBaseline) from op names and per-op mean /
    std in ms."""
    return Vocab(list(names)), SloBaseline(
        mean_ms=np.asarray(mu, dtype=np.float32),
        std_ms=np.asarray(sigma, dtype=np.float32),
    )
