"""The dispatch seam (counterpart of ``microrank_tpu/dispatch/``): the
router (``router.DispatchRouter``: stacked groups, double-buffered
staging, the fused pair program) that serve and the stream engine rank
through, the warmup manifest (``cache``) and its replay (``warmup``)."""

from .cache import (
    WARMUP_MANIFEST_NAME,
    CompileCacheProbe,
    configure_compile_cache,
    load_manifest,
    manifest_kernels,
    manifest_occupancies,
    manifest_shapes,
    record_manifest_entry,
    resolve_cache_dir,
)
from .router import DispatchRouter, RouteInfo, bucket_key
from .warmup import graph_like, synthetic_prepared, warm_manifest_shapes, warm_occupancies

__all__ = [
    "CompileCacheProbe",
    "DispatchRouter",
    "RouteInfo",
    "WARMUP_MANIFEST_NAME",
    "bucket_key",
    "configure_compile_cache",
    "graph_like",
    "load_manifest",
    "manifest_kernels",
    "manifest_occupancies",
    "manifest_shapes",
    "record_manifest_entry",
    "resolve_cache_dir",
    "synthetic_prepared",
    "warm_manifest_shapes",
    "warm_occupancies",
]
