"""The dispatch router (``router.DispatchRouter``): the stream engine's
device seam (counterpart of ``microrank_tpu/dispatch/``; its compile
cache and warmup manifest have no counterpart until serve)."""

from .router import DispatchRouter, RouteInfo, bucket_key

__all__ = ["DispatchRouter", "RouteInfo", "bucket_key"]
