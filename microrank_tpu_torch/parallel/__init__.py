"""Stacked windows: several windows' graphs as one program's input
(counterpart of ``microrank_tpu/parallel``, single device; the mesh is
not ported)."""

from .sharded_rank import (
    rank_windows_batched,
    rank_windows_batched_traced,
    stack_window_graphs,
)

__all__ = ["rank_windows_batched", "rank_windows_batched_traced", "stack_window_graphs"]
