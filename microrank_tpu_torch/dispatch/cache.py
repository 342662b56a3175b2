"""The warmup manifest and the kernel-library probe (counterpart of
``microrank_tpu/dispatch/cache.py``).

The JAX package persists compiled XLA programs in a compile cache and
replays a manifest of the program shapes serve and stream dispatched,
so that a restarted process re-traces them before traffic. The port
compiles no programs at run time: its kernels are libraries built once
into ``_build/`` (``utils.build``), and a rank program is a sequence of
launches over staged tensors. What carries over is the manifest
(``warmup_manifest.json``, JAX's name and format, in the directory
``resolve_cache_dir`` names): serve and stream record each (kernel,
occupancy, padded leaf shapes) they dispatch, and a restarted process
dispatches each once at startup (``dispatch.warmup``), so its kernel
libraries are loaded and the allocator and the stacked program have
seen its shapes before the first request.

``CompileCacheProbe`` keeps its name and its metric
(``microrank_compile_cache_events_total``): an observation after a
warmup dispatch is a "miss" when the process built a kernel library
since the last one (``utils.build.builds`` grew), else a "hit" (every
library it needed was loaded from ``_build/``).
"""

from __future__ import annotations

import json
import logging
import os
from pathlib import Path
from typing import List, Optional

log = logging.getLogger("microrank_tpu_torch.dispatch.cache")

WARMUP_MANIFEST_NAME = "warmup_manifest.json"


def resolve_cache_dir(runtime=None) -> str:
    """The manifest's directory: MICRORANK_JIT_CACHE (env) >
    RuntimeConfig.compile_cache_dir > ~/.cache/microrank_tpu/jit (the
    JAX package's precedence and default)."""
    env = os.environ.get("MICRORANK_JIT_CACHE")
    if env:
        return env
    if runtime is not None and getattr(runtime, "compile_cache_dir", None):
        return str(runtime.compile_cache_dir)
    return os.path.join(os.path.expanduser("~"), ".cache", "microrank_tpu", "jit")


def configure_compile_cache(runtime=None) -> Optional[str]:
    """Create the manifest's directory; returns it, or None when it
    cannot be made (the manifest is best-effort, as in JAX)."""
    try:
        cache_dir = resolve_cache_dir(runtime)
        os.makedirs(cache_dir, exist_ok=True)
        return cache_dir
    except OSError as exc:
        log.warning("warmup manifest directory unavailable (%s); no manifest", exc)
        return None


class CompileCacheProbe:
    """Hit / miss accounting of the kernel libraries a warmup dispatch
    needed: ``observe()`` after a dispatch reports "miss" when the
    process built a library since the last observation, else "hit",
    both recorded in the metrics registry."""

    def __init__(self, cache_dir: Optional[str]):
        from ..utils import build

        self.cache_dir = Path(cache_dir) if cache_dir else None
        self._builds = build.builds
        self.hits = 0
        self.misses = 0

    def observe(self) -> Optional[str]:
        """Classify the library loads since the last observation."""
        if self.cache_dir is None:
            return None
        from ..obs.metrics import record_compile_cache
        from ..utils import build

        now = build.builds
        event = "miss" if now > self._builds else "hit"
        self._builds = now
        if event == "hit":
            self.hits += 1
        else:
            self.misses += 1
        record_compile_cache(event)
        return event


# --------------------------------------------------------------- manifest


def _manifest_path(cache_dir) -> Path:
    return Path(cache_dir) / WARMUP_MANIFEST_NAME


def load_manifest(cache_dir: Optional[str]) -> List[dict]:
    """Entries recorded by previous processes ([] when absent/corrupt)."""
    if not cache_dir:
        return []
    path = _manifest_path(cache_dir)
    if not path.exists():
        return []
    try:
        data = json.loads(path.read_text())
        return list(data.get("programs", []))
    except (ValueError, OSError) as exc:
        log.warning("warmup manifest unreadable (%s); ignoring", exc)
        return []


def _shape_sig(shape: dict) -> tuple:
    return (
        int(shape.get("occupancy", 1)),
        tuple(tuple(int(d) for d in leaf)
              for leaf in shape.get("leaves", [])),
    )


def record_manifest_entry(
    cache_dir: Optional[str],
    pipeline: str,
    kernel: str,
    occupancies,
    shapes=None,
    max_shapes: int = 8,
) -> None:
    """Merge one warmed program shape into the manifest (occupancies
    union per (pipeline, kernel) key); best-effort.

    ``shapes`` — optional production pad-bucket records, each
    ``{"occupancy": n, "leaves": [[dims...], ...]}`` (the graph's
    padded leaf shapes, i.e. ``bucket_key(graph, kernel)[1:]``). These
    let a restart replay the exact shapes the previous process served
    instead of synthetic approximations; kept newest-first, deduped,
    capped at ``max_shapes`` per (pipeline, kernel).
    """
    if not cache_dir:
        return
    try:
        entries = load_manifest(cache_dir)
        occs = sorted({int(o) for o in occupancies})
        new_shapes = [
            {
                "occupancy": int(s.get("occupancy", 1)),
                "leaves": [
                    [int(d) for d in leaf] for leaf in s.get("leaves", [])
                ],
            }
            for s in (shapes or [])
        ]
        for e in entries:
            if e.get("pipeline") == pipeline and e.get("kernel") == kernel:
                merged = sorted(set(e.get("occupancies", [])) | set(occs))
                old_shapes = list(e.get("shapes", []))
                seen = set()
                merged_shapes = []
                for s in new_shapes + old_shapes:
                    sig = _shape_sig(s)
                    if sig in seen:
                        continue
                    seen.add(sig)
                    merged_shapes.append(s)
                merged_shapes = merged_shapes[: max(0, int(max_shapes))]
                if (
                    merged == e.get("occupancies")
                    and merged_shapes == old_shapes
                ):
                    return  # nothing new — skip the write
                e["occupancies"] = merged
                if merged_shapes:
                    e["shapes"] = merged_shapes
                break
        else:
            entry = {
                "pipeline": pipeline,
                "kernel": kernel,
                "occupancies": occs,
            }
            if new_shapes:
                seen = set()
                deduped = []
                for s in new_shapes:
                    sig = _shape_sig(s)
                    if sig in seen:
                        continue
                    seen.add(sig)
                    deduped.append(s)
                entry["shapes"] = deduped[: max(0, int(max_shapes))]
            entries.append(entry)
        # Atomic and durable (tmp + fsync + rename, utils.atomic).
        from ..utils.atomic import atomic_write_json

        atomic_write_json(_manifest_path(cache_dir), {"programs": entries})
        from ..obs.metrics import record_compile_cache

        record_compile_cache("manifest_write")
    except OSError as exc:
        log.warning("warmup manifest write failed (%s)", exc)


def manifest_occupancies(
    cache_dir: Optional[str], pipeline: str
) -> List[int]:
    """Occupancies a previous ``pipeline`` process recorded (any
    kernel) — the set a warm restart should re-trace."""
    occs = set()
    for e in load_manifest(cache_dir):
        if e.get("pipeline") == pipeline:
            occs.update(int(o) for o in e.get("occupancies", []))
    return sorted(occs)


def manifest_shapes(
    cache_dir: Optional[str], pipeline: str
) -> List[tuple]:
    """Production pad-bucket shapes a previous ``pipeline`` process
    recorded: ``(kernel, occupancy, leaves)`` tuples with ``leaves`` a
    tuple of leaf-shape tuples (the router's bucket key). Shape-faithful
    warmup replays these at startup."""
    out = []
    for e in load_manifest(cache_dir):
        if e.get("pipeline") != pipeline or not e.get("kernel"):
            continue
        for s in e.get("shapes", []):
            occ, leaves = _shape_sig(s)
            out.append((str(e["kernel"]), occ, leaves))
    return out


def manifest_kernels(
    cache_dir: Optional[str], pipeline: str
) -> List[str]:
    """Kernels a previous ``pipeline`` process warmed."""
    kernels = set()
    for e in load_manifest(cache_dir):
        if e.get("pipeline") == pipeline and e.get("kernel"):
            kernels.add(str(e["kernel"]))
    return sorted(kernels)
