"""Run telemetry (counterpart of part of ``microrank_tpu/obs``): the
metrics registry and the ported lanes' metric set, the per-run JSONL
journal, the host-contention sentinel it samples, the span tracer
(``spans``: the table lane's stages as spans in a bounded ring), the
flight recorder that dumps the ring when a stream incident opens
(``flight``) and the HTTP metrics endpoint (``server``, imported where
it is started; it also serves ``/explainz``).

The JAX package's profiler sessions and fleet plane are not ported
(ROADMAP.md 'Port queue' item 11).
"""

from .host import ContentionSentinel
from .journal import JOURNAL_NAME, RunJournal, journal_parts, read_journal
from .registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    diff_registries,
    get_registry,
    merge_registries,
    registry_from_json,
    set_registry,
)
from .spans import Span, SpanContext, SpanTracer, configure_tracer, get_tracer, set_tracer

__all__ = [
    "ContentionSentinel",
    "Counter",
    "Gauge",
    "Histogram",
    "JOURNAL_NAME",
    "MetricsRegistry",
    "RunJournal",
    "Span",
    "SpanContext",
    "SpanTracer",
    "configure_tracer",
    "diff_registries",
    "get_registry",
    "get_tracer",
    "merge_registries",
    "journal_parts",
    "read_journal",
    "registry_from_json",
    "set_registry",
    "set_tracer",
]
