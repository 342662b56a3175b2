"""Warmup replay: dispatch the shapes a process will need before
traffic arrives (counterpart of ``microrank_tpu/dispatch/warmup.py``).

A small synthetic abnormal window goes through the production seam
(the C++ detector and build, ``graph.table_ops.prepare_window_graph``)
and through the router at each target occupancy. In the port there is
no program to compile: a warmup dispatch loads the kernel libraries
(built into ``_build/`` at first use), sizes the allocator's pools and
runs the stacked program (K18) at the occupancy once, so the first
request pays none of it. Serve runs it at startup (its configured
occupancies plus what the manifest recorded); the stream engine replays
the manifest on a warm restart.

Unlike JAX's serve warmup, which degrades a failed warmup dispatch to
the numpy oracle, a failed warmup dispatch here raises, at a configured
occupancy and at a recorded shape alike: a service that cannot launch
its kernels must not start answering from the CPU. Only a recorded
shape that no longer fits this build (``graph_like`` returns None) is
skipped, counted in ``microrank_warm_shapes_total``, as in JAX.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Iterable, Optional, Tuple

import numpy as np

log = logging.getLogger("microrank_tpu_torch.dispatch.warmup")


def synthetic_prepared(config) -> Optional[Tuple[object, list, str]]:
    """(host graph, op names, kernel) of a small synthetic abnormal
    window prepared through the production seam, or None when the
    fixed-seed case does not partition."""
    from ..graph.table_ops import (
        compute_slo_from_table,
        detect_window_partition,
        prepare_window_graph,
    )
    from ..testing import SyntheticConfig, generate_case
    from ..testing.synthetic import spans_table

    case = generate_case(SyntheticConfig(n_operations=12, n_traces=60, seed=0))
    normal = spans_table(case.normal, case.n_operations)
    abnormal = spans_table(case.abnormal, case.n_operations)
    vocab, baseline = compute_slo_from_table(normal, stat=config.detector.slo_stat)
    mask, nrm, abn, _ = detect_window_partition(
        abnormal, int(abnormal.start_us.min()), int(abnormal.end_us.max()), vocab, baseline,
        config.detector)
    if len(abn) < config.detector.min_abnormal_traces or not len(nrm) or not len(abn):
        log.warning("warmup case did not partition; skipping warmup")
        return None
    graph, names, kernel, _ = prepare_window_graph(abnormal, mask, nrm, abn, config)
    return graph, names, kernel


def graph_like(config, kernel: str, leaves_shapes) -> Optional[object]:
    """A dispatchable host graph whose leaves have the shapes
    ``leaves_shapes`` (a recorded ``bucket_key(graph, kernel)[1:]``):
    the synthetic window prepared with ``kernel`` forced, each leaf
    resized to its recorded shape (the synthetic values in the
    overlapping region, zeros past it; an ``*_indptr`` leaf repeats its
    last value, so it stays monotone). None when the record no longer
    matches this build's leaves (kernel or config drift): the caller
    skips it."""
    from ..graph.structures import PartitionGraph

    forced = dataclasses.replace(config, runtime=dataclasses.replace(config.runtime,
                                                                     kernel=kernel))
    prepared = synthetic_prepared(forced)
    if prepared is None:
        return None
    graph, _, built_kernel = prepared
    if built_kernel != kernel:
        return None
    fields = PartitionGraph._fields
    targets = [tuple(int(d) for d in s) for s in leaves_shapes]
    if len(targets) != 2 * len(fields):
        return None
    parts = []
    for p, part in enumerate((graph.normal, graph.abnormal)):
        leaves = {}
        for i, f in enumerate(fields):
            src = np.asarray(getattr(part, f))
            target = targets[p * len(fields) + i]
            if src.shape == target:
                leaves[f] = getattr(part, f)
                continue
            if src.ndim != len(target):
                return None
            dst = np.zeros(target, dtype=src.dtype)
            overlap = tuple(slice(0, min(a, b)) for a, b in zip(src.shape, target))
            dst[overlap] = src[overlap]
            if "indptr" in f and src.size and dst.ndim == 1 and dst.size > src.size:
                dst[src.size:] = src[-1]
            leaves[f] = dst
        parts.append(part._replace(**leaves))
    return graph._replace(normal=parts[0], abnormal=parts[1])


def warm_manifest_shapes(router, config, cache_dir, pipeline: str, probe=None) -> int:
    """Dispatch every shape the manifest recorded for ``pipeline``
    (``dispatch.cache.manifest_shapes``) through the router once.
    Returns the signatures warmed. A stale record (``graph_like`` gives
    None) is skipped and counted; a dispatch that fails is counted and
    raises."""
    from ..obs.spans import get_tracer
    from .cache import manifest_shapes

    sigs = manifest_shapes(cache_dir, pipeline)
    if not sigs:
        return 0
    tracer = get_tracer()
    was_enabled = tracer.enabled
    tracer.enabled = False
    warmed = 0
    try:
        conv = bool(config.runtime.convergence_trace)
        for kernel, occ, leaves_shapes in sigs:
            graph = graph_like(config, kernel, leaves_shapes)
            if graph is None:
                _record_warm_shape("skipped")
                continue
            try:
                router.rank_batch([graph] * max(1, int(occ)), kernel, conv_trace=conv,
                                  record=False)
            except Exception:
                _record_warm_shape("failed")
                log.error("shape warmup failed for kernel=%s occ=%d", kernel, occ)
                raise
            if probe is not None:
                probe.observe()
            warmed += 1
            _record_warm_shape("warmed")
        return warmed
    finally:
        tracer.enabled = was_enabled


def _record_warm_shape(outcome: str) -> None:
    from ..obs.metrics import record_warm_shape

    record_warm_shape(outcome)


def warm_occupancies(router, config, occupancies: Iterable[int], probe=None) -> Optional[str]:
    """Dispatch the stacked program at each occupancy through the router
    (its metrics not recorded, the span tracer paused so that warmup
    never reaches a flight dump). A failed dispatch raises. Returns the
    kernel warmed, or None when nothing ran."""
    from ..obs.spans import get_tracer

    tracer = get_tracer()
    was_enabled = tracer.enabled
    tracer.enabled = False
    try:
        prepared = synthetic_prepared(config)
        if prepared is None:
            return None
        graph, _, kernel = prepared
        conv = bool(config.runtime.convergence_trace)
        for occ in occupancies:
            router.rank_batch([graph] * max(1, int(occ)), kernel, conv_trace=conv,
                              record=False)
            if probe is not None:
                probe.observe()
        return kernel
    finally:
        tracer.enabled = was_enabled
