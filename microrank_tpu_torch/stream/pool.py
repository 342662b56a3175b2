"""Build worker pool: host graph builds off the dispatch thread
(counterpart of ``microrank_tpu/stream/pool.py``).

The stream engine owns the card from one thread and must not spend its
time in host graph construction (admission, detection, the C++ build)
while the card sits idle: it submits window N+1's build here while its
own thread issues window N's rank program. Only host work runs here;
every launch stays on the engine's thread. (JAX's serve scheduler
shares the pool; serve is not ported yet.)
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Optional, Set



class BuildWorkerPool:
    """A small thread pool with build accounting.

    ``build_threads`` records the idents that ran builds (tests assert
    builds left the dispatch thread); the inflight gauge and build
    counter land in the shared metrics registry.
    """

    def __init__(self, workers: int = 2, name: str = "mr-build"):
        self.workers = max(1, int(workers))
        self._ex = ThreadPoolExecutor(
            max_workers=self.workers, thread_name_prefix=name
        )
        # Submitters (the engine thread) and workers both touch the
        # accounting.
        self._lock = threading.Lock()
        self._inflight = 0
        self.build_threads: Set[int] = set()
        self.builds = 0

    def submit(
        self,
        fn: Callable,
        *args,
        on_done: Optional[Callable] = None,
        **kwargs,
    ) -> Future:
        """Run ``fn(*args, **kwargs)`` on a worker; ``on_done(future)``
        (when given) fires on the worker thread after completion —
        exceptions from ``fn`` live in the future, not the worker.

        Trace propagation: the submitter's ambient span context is
        captured HERE (contextvars are per-thread, so the worker would
        otherwise start blank) and re-attached around the build — the
        window/request trace keeps its causal chain across the pool
        hop, which is exactly what the self-tracing layer exists to
        show."""
        from ..obs.metrics import record_build_pool
        from ..obs.spans import get_tracer

        tracer = get_tracer()
        ctx = tracer.current_context()
        with self._lock:
            self._inflight += 1
            record_build_pool(inflight=self._inflight)

        def _run():
            t0 = time.monotonic()
            try:
                with tracer.attach(ctx):
                    return fn(*args, **kwargs)
            finally:
                with self._lock:
                    self._inflight -= 1
                    self.builds += 1
                    self.build_threads.add(threading.get_ident())
                    record_build_pool(
                        inflight=self._inflight,
                        build_seconds=time.monotonic() - t0,
                    )

        fut = self._ex.submit(_run)
        if on_done is not None:
            fut.add_done_callback(on_done)
        return fut

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def shutdown(self, wait: bool = True, cancel: bool = False) -> None:
        """Stop the pool. ``cancel`` drops builds still QUEUED (never a
        running one) — the fast path for an engine abort, where ranking
        the remaining windows is pointless; callers that coalesce
        pending builds (the dispatch router's burst grouping waits on
        ``Future.result()``) must NOT cancel, or the waiters would see
        CancelledError instead of a graph."""
        self._ex.shutdown(wait=wait, cancel_futures=cancel)
