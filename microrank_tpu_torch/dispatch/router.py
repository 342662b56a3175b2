"""The dispatch router (counterpart of
``microrank_tpu/dispatch/router.py``): one device seam for the stream
engine.

* **routing**: a batch of same-bucket windows (equal ``bucket_key``)
  runs as the stacked program (K18, ``parallel.stack_window_graphs``)
  for B > 1 and the one-window program for B = 1 (JAX's vmapped
  program is the same function at any B). JAX's size routing to a mesh
  is item 12: a configured mesh raises.
* **double-buffered staging**: ``rank_batch(next_batch=...)`` issues
  the next batch's staging (its host pack and its ``non_blocking`` copy
  to the card, ``blob.stage_windows_batched``) after the current
  batch's program and before its fetch, so the copy is queued behind
  the program and the host pack overlaps it; the staged handle is held
  one slot deep and consumed by the next call with the same graphs, or
  dropped (``drop_prestaged``).
* **burst coalescing**: ``bucket_key`` lives here; the stream engine
  groups its pending builds with it before calling ``rank_batch``.
* **the fused pair program**: ``rank_fused`` stages one window and its
  warm init as one blob and fetches its nine outputs in one copy (K19).

The router has no thread of its own: every method runs on the caller's
thread, which owns the card's stream.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..config import MicroRankConfig
from ..graph.structures import PartitionGraph

log = logging.getLogger("microrank_tpu_torch.dispatch")


def bucket_key(graph, kernel: str) -> Tuple:
    """Shape signature of a (kernel-stripped) host window graph: two
    graphs with equal keys stack into one group (JAX's jit cache key
    modulo config: every leaf's shape, normal partition then
    abnormal)."""
    return (kernel,) + tuple(
        tuple(np.shape(getattr(part, f))) for part in (graph.normal, graph.abnormal)
        for f in PartitionGraph._fields
    )


def graph_bytes(graph) -> int:
    """Bytes of a host window graph's leaves (JAX's
    ``graph_device_bytes``)."""
    return sum(int(np.asarray(getattr(part, f)).nbytes)
               for part in (graph.normal, graph.abnormal) for f in PartitionGraph._fields)


@dataclass
class RouteInfo:
    """What one router dispatch did (journal, chip_smoke)."""

    route: str                  # "vmapped" | "fused"
    kernel: str                 # kernel dispatched
    windows: int                # batch occupancy
    footprint_bytes: int        # host bytes staged
    dispatch_ms: float = 0.0    # issue -> results on the host
    overlap_ms: float = 0.0     # next batch's staging issued behind this program
    prestaged: bool = False     # this batch's staging was itself issued ahead


class _Staged:
    __slots__ = ("key", "route", "kernel", "handle", "footprint")

    def __init__(self, key, route, kernel, handle, footprint=0):
        self.key = key
        self.route = route
        self.kernel = kernel
        self.handle = handle
        self.footprint = footprint


class DispatchRouter:
    """Route prepared window graphs to the right program. ``graphs``
    passed to :meth:`rank_batch` are host graphs (``host_subset``-
    stripped for their kernel) sharing one bucket (equal
    :func:`bucket_key`): callers coalesce before routing."""

    def __init__(self, config: MicroRankConfig, mesh=None, device=None):
        from ..utils.device import resolve_device

        if mesh is not None:
            raise NotImplementedError("the sharded route (a mesh) is not ported: ROADMAP.md, "
                                      "port queue item 12")
        self.config = config
        self.cfg = config.dispatch
        self.device = resolve_device(config.runtime.device if device is None else device)
        self._prestaged: Optional[_Staged] = None
        self.dispatches = 0

    def plan(self, graphs, kernel: str) -> Tuple[str, str, int]:
        """(route, kernel, footprint_bytes) of one batch: "vmapped" on
        the one card (JAX's decision table with no mesh configured)."""
        return "vmapped", kernel, sum(graph_bytes(g) for g in graphs)

    def _stage(self, graphs, kernel: str) -> _Staged:
        from ..parallel import stack_window_graphs
        from ..rank_backends.blob import stage_windows_batched

        route, resolved, footprint = self.plan(graphs, kernel)
        host = graphs[0] if len(graphs) == 1 else stack_window_graphs(list(graphs))
        handle = stage_windows_batched(host, resolved, self.device,
                                       self.config.runtime.blob_staging)
        return _Staged(self._key(graphs, kernel), route, resolved, handle, footprint)

    @staticmethod
    def _key(graphs, kernel: str) -> Tuple:
        return (kernel,) + tuple(id(g) for g in graphs)

    def _take_prestaged(self, graphs, kernel: str) -> Optional[_Staged]:
        staged = self._prestaged
        self._prestaged = None
        if staged is not None and staged.key == self._key(graphs, kernel):
            return staged
        return None  # a mismatch drops the cached staging unused

    def rank_batch(self, graphs, kernel: str, conv_trace: bool = False,
                   next_batch: Optional[Tuple[List, str]] = None, record: bool = True):
        """Rank one same-bucket batch; returns ``(outs, RouteInfo)`` with
        ``outs`` host arrays with a leading [B] axis: (top_idx [B, k],
        top_scores [B, k], n_valid [B]) plus (residuals [B, 2, I],
        n_iters [B]) with ``conv_trace``, fetched in one copy.
        ``next_batch=(graphs, kernel)`` double-buffers its staging behind
        this batch's program."""
        from ..obs.spans import get_tracer
        from ..rank_backends.blob import dispatch_windows_staged
        from ..rank_backends.torch_cuda import pack_rank_outputs, unpack_rank_outputs

        tracer = get_tracer()
        t0 = time.monotonic()
        staged = self._take_prestaged(graphs, kernel)
        prestaged = staged is not None
        if staged is None:
            with tracer.span("staging", service="dispatch", kernel=kernel, windows=len(graphs)):
                staged = self._stage(graphs, kernel)
        cfg = self.config
        with tracer.span("device_dispatch", service="dispatch", kernel=staged.kernel,
                         route=staged.route, windows=len(graphs)):
            dev_outs = dispatch_windows_staged(staged.handle, cfg.pagerank, cfg.spectrum,
                                               conv_trace=conv_trace)
            packed = pack_rank_outputs(dev_outs, staged.handle.pinned)
        overlap_s = 0.0
        if next_batch is not None and self.cfg.double_buffer:
            t_stage = time.monotonic()
            try:
                with tracer.span("prestage", service="dispatch"):
                    self._prestaged = self._stage(*next_batch)
                overlap_s = time.monotonic() - t_stage
            except Exception as exc:  # noqa: BLE001 - a broken next batch
                # must not fail this one; it surfaces on its own turn.
                log.warning("double-buffer prestage failed: %s", exc)
        with tracer.span("result_fetch", service="dispatch", route=staged.route):
            outs = unpack_rank_outputs(packed)
        if len(graphs) == 1:
            outs = tuple(np.asarray(o)[None] for o in outs)
        self.dispatches += 1
        info = RouteInfo(
            route=staged.route, kernel=staged.kernel, windows=len(graphs),
            footprint_bytes=staged.footprint,
            dispatch_ms=round((time.monotonic() - t0) * 1e3, 3),
            overlap_ms=round(overlap_s * 1e3, 3), prestaged=prestaged,
        )
        if record:
            from ..obs.metrics import record_dispatch_route, stage_seconds

            record_dispatch_route(info.route, info.windows, overlap_s)
            stage_seconds().observe(info.dispatch_ms / 1e3, stage="dispatch")
        return outs, info

    def rank_fused(self, graph, kernel: str, init=None, record: bool = True):
        """Rank ONE window through the fused pair program (K19,
        ``blob.stage_rank_window_warm``): its host graph and ``init``
        staged as one blob, both solves and the epilogue, the nine
        outputs fetched in one copy. Returns ``(outs, RouteInfo)``, outs
        the host 9-tuple (top_idx, top_scores, n_valid, residuals,
        n_iters, score_n, rv_n, score_a, rv_a)."""
        from ..obs.spans import get_tracer
        from ..rank_backends.blob import stage_rank_window_warm
        from ..rank_backends.torch_cuda import pack_rank_outputs, unpack_rank_outputs

        tracer = get_tracer()
        t0 = time.monotonic()
        cfg = self.config
        with tracer.span("device_dispatch", service="dispatch", kernel=kernel, route="fused",
                         windows=1):
            dev_outs, pinned = stage_rank_window_warm(
                graph, init, cfg.pagerank, cfg.spectrum, kernel, self.device,
                cfg.runtime.blob_staging)
            packed = pack_rank_outputs(dev_outs, pinned)
        with tracer.span("result_fetch", service="dispatch", route="fused"):
            outs = unpack_rank_outputs(packed)
        self.dispatches += 1
        info = RouteInfo(route="fused", kernel=kernel, windows=1,
                         footprint_bytes=graph_bytes(graph),
                         dispatch_ms=round((time.monotonic() - t0) * 1e3, 3))
        if record:
            from ..obs.metrics import record_dispatch_route, stage_seconds

            record_dispatch_route(info.route, info.windows, 0.0)
            stage_seconds().observe(info.dispatch_ms / 1e3, stage="dispatch")
        return outs, info

    def drop_prestaged(self) -> None:
        """Discard the cached prestaged batch (the caller aborted it)."""
        self._prestaged = None
