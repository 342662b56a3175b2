"""Ranking backends: the device program lives in ``torch_cuda`` (staged
by ``blob``); ``NumpyRefBackend`` is the float64 numpy oracle
(counterpart of ``microrank_tpu/rank_backends/__init__.py``'s), which
serve's degradation ranks with when a device dispatch fails twice."""

from __future__ import annotations

from typing import List, Tuple

from ..config import MicroRankConfig
from . import numpy_ref


def validate_partitions(normal_ids, abnormal_ids) -> None:
    """Both partitions must be non-empty to rank a window (the JAX
    package's ``rank_backends.base.validate_partitions``)."""
    if not len(normal_ids) or not len(abnormal_ids):
        raise ValueError(
            "rank_window requires non-empty normal AND abnormal trace "
            f"partitions (got {len(normal_ids)} normal / "
            f"{len(abnormal_ids)} abnormal); windows that fail to "
            "partition should be skipped, as the reference does at "
            "online_rca.py:176-178"
        )


class NumpyRefBackend:
    """Oracle backend: the reference's semantics over graph dicts, in
    float64 on the host."""

    name = "numpy_ref"

    def __init__(self, config: MicroRankConfig = MicroRankConfig()):
        self.config = config
        # The residual traces of the latest rank_window call when
        # runtime.convergence_trace is on: {iterations, final_residual,
        # residuals: {normal, abnormal}}.
        self.last_convergence = None

    def rank_window(self, table, normal_ids, abnormal_ids) -> Tuple[List[str], List[float]]:
        """Rank one window: ``table`` a ``SpanTable`` holding the
        window's rows, the partitions as trace codes into its
        ``trace_names``. Returns (names, scores)."""
        from ..graph.dicts import pagerank_graph_dicts

        normal_ids = list(normal_ids)
        abnormal_ids = list(abnormal_ids)
        validate_partitions(normal_ids, abnormal_ids)
        normal_graph = pagerank_graph_dicts(normal_ids, table)
        abnormal_graph = pagerank_graph_dicts(abnormal_ids, table)
        conv = {} if self.config.runtime.convergence_trace else None
        out = numpy_ref.rank_window_dicts(
            normal_graph,
            abnormal_graph,
            n_normal_traces=len(normal_ids),
            n_abnormal_traces=len(abnormal_ids),
            pagerank_cfg=self.config.pagerank,
            spectrum_cfg=self.config.spectrum,
            conv_out=conv,
        )
        self.last_convergence = None
        if conv is not None:
            joint = [max(n, a) for n, a in zip(conv["normal"], conv["abnormal"])]
            self.last_convergence = {
                "iterations": conv["iterations"],
                "final_residual": joint[-1] if joint else None,
                "residuals": {"normal": conv["normal"], "abnormal": conv["abnormal"]},
            }
        return out


__all__ = ["NumpyRefBackend", "numpy_ref", "validate_partitions"]
