"""Span-level self-tracing: the pipeline's own trace (counterpart of
``microrank_tpu/obs/spans.py``, as far as the table lane uses it).

* a **trace** is one unit of pipeline work: in the table lane one
  detection window (``trace_id = "win-<start>"``);
* a **span** is one stage of that trace (``detect``, ``rank_dispatch``,
  ``rank_wait``, ...), parent-linked through a ``contextvars`` trace
  context that callers carry across threads explicitly
  (``current_context()`` where work is handed off, ``attach()`` on the
  worker), or pin with ``StageTimings(ctx=...)``;
* completed spans land in a bounded in-memory **ring** (a locked deque),
  each counted in ``microrank_spans_recorded_total``.

Span ids, trace ids and parent links are made as the JAX package makes
them, so one run gives the same ring in both packages, times apart. The
flight recorder (``obs.flight``) dumps the ring when a stream incident
opens. Not ported: the chaos hooks (``_chaos_stage``, ``_maybe_inject``;
ROADMAP.md, port queue item 11).
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

# The ambient trace context of the current thread of execution. Worker
# threads do not inherit it: a seam captures it at submit time and
# attaches it on the worker.
_CTX: "contextvars.ContextVar[Optional[SpanContext]]" = contextvars.ContextVar(
    "microrank_span_ctx", default=None
)


@dataclass(frozen=True)
class SpanContext:
    """What a child span needs from its parent: its trace and the span
    id it links to."""

    trace_id: str
    span_id: str


@dataclass
class Span:
    """One completed pipeline stage."""

    trace_id: str
    span_id: str
    parent_id: Optional[str]
    name: str                    # stage name (the journal's vocabulary)
    service: str                 # subsystem: pipeline in the table lane
    thread: str                  # recording thread's name
    start_us: int                # epoch microseconds
    dur_us: int
    attrs: Dict[str, object] = field(default_factory=dict)


class SpanTracer:
    """Bounded-ring span recorder with contextvar trace propagation.
    Thread-safe (the ring append holds one lock); ``enabled=False``
    makes every call a near no-op, so the tracer stays wired."""

    def __init__(self, capacity: int = 8192, enabled: bool = True):
        self.enabled = bool(enabled)
        self.capacity = max(16, int(capacity))
        self._ring: "deque[Span]" = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self.recorded = 0  # lifetime spans (the ring may hold fewer)

    def new_trace(self, trace_id: str) -> SpanContext:
        """Root context for one unit of pipeline work. Children link to
        the root span id; the owner records the root itself, if at all,
        with ``record_span``."""
        return SpanContext(str(trace_id), f"s{next(self._ids):08x}")

    @staticmethod
    def current_context() -> Optional[SpanContext]:
        """The ambient context on this thread."""
        return _CTX.get()

    @contextlib.contextmanager
    def attach(self, ctx: Optional[SpanContext]) -> Iterator[None]:
        """``ctx`` as the ambient context for the block (the explicit
        cross-thread hand-off); None is a no-op."""
        if ctx is None:
            yield
            return
        token = _CTX.set(ctx)
        try:
            yield
        finally:
            _CTX.reset(token)

    @contextlib.contextmanager
    def span(self, name: str, service: str = "pipeline",
             ctx: Optional[SpanContext] = None, **attrs) -> Iterator[Optional[SpanContext]]:
        """Record one stage span around the block. Its parent: ``ctx``
        when given, else the ambient context; with neither it roots a
        fresh anonymous trace. Its own context is ambient inside the
        block."""
        if not self.enabled:
            yield None
            return
        parent = ctx if ctx is not None else _CTX.get()
        trace_id = parent.trace_id if parent else f"trace-{next(self._ids):08x}"
        own = SpanContext(trace_id, f"s{next(self._ids):08x}")
        token = _CTX.set(own)
        start_us = int(time.time() * 1e6)
        p0 = time.perf_counter()
        try:
            yield own
        finally:
            dur_us = int((time.perf_counter() - p0) * 1e6)
            _CTX.reset(token)
            self._record(Span(
                trace_id=trace_id,
                span_id=own.span_id,
                parent_id=parent.span_id if parent else None,
                name=str(name),
                service=str(service),
                thread=threading.current_thread().name,
                start_us=start_us,
                dur_us=dur_us,
                attrs=dict(attrs) if attrs else {},
            ))

    def record_span(self, name: str, ctx: SpanContext, start_us: int, dur_us: int,
                    service: str = "pipeline", parent_id: Optional[str] = None,
                    **attrs) -> None:
        """Record a span whose lifetime was tracked elsewhere (a root
        span that straddles hand-offs no ``with`` block can wrap)."""
        if not self.enabled:
            return
        self._record(Span(
            trace_id=ctx.trace_id,
            span_id=ctx.span_id,
            parent_id=parent_id,
            name=str(name),
            service=str(service),
            thread=threading.current_thread().name,
            start_us=int(start_us),
            dur_us=max(0, int(dur_us)),
            attrs=dict(attrs) if attrs else {},
        ))

    def _record(self, span: Span) -> None:
        with self._lock:
            self._ring.append(span)
            self.recorded += 1
        from .metrics import spans_recorded

        spans_recorded().inc()

    def snapshot(self) -> List[Span]:
        """A copy of the ring, oldest first."""
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    @property
    def dropped(self) -> int:
        """Lifetime spans that fell off the ring."""
        with self._lock:
            return self.recorded - len(self._ring)


_tracer_lock = threading.Lock()
_tracer: Optional[SpanTracer] = None


def get_tracer() -> SpanTracer:
    """The process tracer every stage records into. It starts disabled:
    a run arms it from its config (``configure_tracer``), so library
    imports and unit tests pay nothing."""
    global _tracer
    with _tracer_lock:
        if _tracer is None:
            _tracer = SpanTracer(enabled=False)
        return _tracer


def set_tracer(tracer: Optional[SpanTracer]) -> None:
    global _tracer
    with _tracer_lock:
        _tracer = tracer


def configure_tracer(obs_config) -> SpanTracer:
    """Install a fresh tracer from an ObsConfig (``TableRCA.run`` calls
    this at its start), so one ring never mixes two runs' spans."""
    tracer = SpanTracer(capacity=obs_config.span_ring, enabled=obs_config.spans)
    set_tracer(tracer)
    return tracer
